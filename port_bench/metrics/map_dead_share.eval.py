"""Share of the map-conv output cells the program computed in a step that
no mask leaves live: 1 − (live output cells a query, work/_tan.py, × the
batch) / the program's counter (`map_epilogue.cells` of
drn_tpu_torch/ops/cuda/map_epilogue.py over the traced sessions' steps,
which entries/tan_eval.py records as `map_conv_cells`), in %. None where
the window has no such count."""

from port_bench import spec


def read(w):
    cells = getattr(w, "map_conv_cells", None)
    if not cells:
        return None
    live = spec.work("_tan").live_cells(w.dims) * w.batch
    return 100.0 * (1.0 - live / cells)
