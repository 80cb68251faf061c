"""Faults planted under the timed path, to show that the check catches
them: each replaces a method of the port's engine with one that breaks it,
the fused decode step (``ServeEngine._fused_decode_step``, which returns
the step's logits) unless the fault's ``replaces`` names another.
``control.py --fault <name>`` reads them at a cell's own size; the CPU
tests read them on the rehearsal cells.  ``exchange_left_out`` breaks only
a cell served over several shards (``ACROSS_CARDS``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

#: the faults that only a cell over several shards can have
ACROSS_CARDS = ("exchange_left_out",)


def table() -> Tuple[Any, Dict[str, Callable]]:
    """The engine class and, by name, each fault's replacement method."""
    from repro_torch.runtime.serve_loop import ServeEngine

    step = ServeEngine._fused_decode_step
    attn_sum = ServeEngine._attn_sum

    def state_unchanged(self, *args):
        """The step's KV writes are undone: the pool is left as it was."""
        pools = [p for sh in self.shards for p in sh.pools() if p is not None]
        saved = [p.clone() for p in pools]
        out = step(self, *args)
        for p, s in zip(pools, saved):
            p.copy_(s)
        return out

    def half_batch_left_out(self, *args):
        """The second half of the rows gets the first half's logits."""
        out = step(self, *args).clone()
        b = out.shape[0]
        out[b // 2:] = out[:b - b // 2]
        return out

    def token_altered(self, *args):
        """Every row's best logit moves to the next token id."""
        out = step(self, *args).clone()
        nxt = (out.argmax(-1) + 1) % out.shape[-1]
        out.scatter_(1, nxt[:, None], out.max(-1, keepdim=True).values + 1.0)
        return out

    def exchange_left_out(self, i, parts):
        """Every shard's attention partial but shard 0's is left out of
        the sum across shards: nothing of theirs reaches shard 0."""
        return attn_sum(self, i, parts[:1] + [p.new_zeros(p.shape)
                                              for p in parts[1:]])

    exchange_left_out.replaces = "_attn_sum"

    return ServeEngine, {f.__name__: f for f in (
        state_unchanged, half_batch_left_out, token_altered,
        exchange_left_out)}


def replaced(fault: Callable) -> str:
    """The name of the engine method ``fault`` stands in for."""
    return getattr(fault, "replaces", "_fused_decode_step")


def plant(name: str) -> None:
    """Put fault ``name`` in the engine's place for this process."""
    cls, faults = table()
    setattr(cls, replaced(faults[name]), faults[name])
