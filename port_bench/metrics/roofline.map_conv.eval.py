"""2D-TAN's map convs: their live work a step (work/_tan.py `map_conv`:
only products whose input and output cells are both live, at the step's
batch; the larger of operations over the bf16 peak and bytes over HBM's)
over the device time of the kernels launched inside the program's range
`drn.model.map_conv` (the convs and their epilogues), in %."""

from port_bench import spans, spec


def read(w):
    kernels = spans.launched_in(w.trace, "drn.model.map_conv")
    if not kernels:
        return None
    return w.roofline(spec.work("_tan").map_conv(w.dims, w.batch), kernels)
