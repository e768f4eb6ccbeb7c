"""Plans per compress call, counted from the program's spans in the
traced run: the copy-free plan of each batch (`density.engine.plan`)
and each masked plan of the fixed point over the copy blocks
(`density.engine.plan_masked`)."""

from portbench import spans


def read(ctx):
    return spans.count(ctx, "compress", ("engine.plan",))
