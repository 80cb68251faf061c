"""The whole step's share of the cards' peak: model FLOPs of every token
processed in the traced stretch (decoded tokens with their heads,
prefilled tokens; attention over each token's context), over the
stretch's length x cards x peak."""

from benchlib import work


def read(run):
    if not run.on_card or run.stretch is None:
        return None
    s = run.shape
    flops = sum(work.decode_flops(s, b, ctx)
                for _, t1, b, ctx, _ in run.rec.decodes
                if run.in_stretch(t1))
    flops += sum(work.prefill_flops(s, cached, new)
                 for t0, _, cached, new in run.rec.prefills
                 if run.in_stretch(t0))
    if not flops:
        return None
    length = (run.stretch[1] - run.stretch[0]) / 1e9
    return 100.0 * flops / (length * run.chips * work.PEAK_FLOPS[s.dtype])
