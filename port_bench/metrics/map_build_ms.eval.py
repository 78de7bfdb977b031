"""Device ms a step of the kernels launched inside the program's ranges
`drn.model.frame`, `drn.model.map_build` and `drn.model.fusion`: 2D-TAN's
clip features, its moment map and the fusion that scatters it into the
2-D map. None where the program opens none of them."""

from port_bench import spans


def read(w):
    parts = [spans.span_ms(w, f"drn.model.{p}")
             for p in ("frame", "map_build", "fusion")]
    if all(p is None for p in parts):
        return None
    return sum(p for p in parts if p is not None)
