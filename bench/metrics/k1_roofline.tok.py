"""K1 (the paged chunk attention: fused decode and suffix prefill) at its
roofline: the least time of every K1 call in the traced stretch, counted
from the calls' shapes, over the device time of K1's kernel there."""

from benchlib import work
from benchlib.trace import kernel_s

#: K1's kernel name in the device trace
KERNEL = "paged_tc_kernel"


def read(run):
    busy = kernel_s(run.trace, KERNEL)
    s = run.shape
    bound = sum(work.paged_attention_bound_s(s, b, 1, ctx, distinct)
                for t0, _, b, ctx, distinct in run.rec.decodes
                if run.in_stretch(t0))
    bound += sum(work.paged_attention_bound_s(s, 1, new, cached + new)
                 for t0, _, cached, new in run.rec.prefills
                 if cached and run.in_stretch(t0))
    return 100.0 * bound / busy if busy and bound else None
