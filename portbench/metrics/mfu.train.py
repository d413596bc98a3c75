"""The train step's share of the chips' peak: the step's least time (6 x the
weights a token is multiplied by x tokens plus causal attention's products
over the bf16 rate, plus AdamW's 28 bytes a parameter over the memory rate;
recomputation not counted), shared evenly by the chips the mix's mesh spans
(one without a mesh), over the mean time of the window's steps."""
import math

from portbench import counts


def read(ctx):
    rs = [r for r in ctx.records if not r.traced] or ctx.records
    if not rs:
        return None
    least = counts.train_least_s(ctx.m, ctx.mix["batch"], ctx.mix["seq_len"],
                                 math.prod(ctx.mix.get("mesh", ())))
    return 100.0 * least * len(rs) / sum(r.done - r.start for r in rs)
