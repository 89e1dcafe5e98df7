"""The whole unit's share of the card's f32 peak, in %: the model FLOPs of
the window's units over (the traced window x 67 TFLOP/s; TF32 is off).
A unit's model FLOPs are those of the reference's same unit (the
matmuls and convolutions its autograd graph runs, by
torch.utils.flop_counter, each sparse convolution by its present (row,
tap) pairs; surfbench/harness.py model_flops), times the units done.
``mfu.val`` and ``mfu.train``; BENCHMARK.json's ``workloads`` lists say
which cells report which."""


def read(ctx):
    if ctx.tr is None or ctx.flops_per_unit is None:
        return None
    return 100.0 * ctx.flops_per_unit * ctx.units / (ctx.tr.window_s * 67e12)
