"""Device ms a step of the kernels launched outside the DRN forward and
outside the optimizer's step: the batch's gather from the table, the loss
and the whole backward (on autograd's thread)."""


def read(w):
    return w.per_step_ms(w.trace.outside(["pb.forward", "pb.optimizer"]))
