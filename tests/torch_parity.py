"""What the port's serving engine reports beyond the JAX reference's, for
the parity tests that compare records of the two packages.

The port's one-shard fused decode step runs at padded batch rungs and, on
a card, replays them as CUDA graphs
(``repro_torch.runtime.serve_loop.DECODE_RUNGS``); the reference has
neither, so the port's engine keeps three counters, in its metrics and in
``stats()``, and one histogram more.  A record leaves them out only where
the engine that made it is the port's, and holds there that it has every
one: the rest of the two records is compared whole."""

#: the port's decode-graph keys of ``ServeEngine.stats()``
GRAPH_STATS = ("decode_graph_captures", "decode_graph_replays",
               "decode_padded_rows")
#: the same counters in the metrics registry, and the capture histogram
GRAPH_METRICS = {**{f"engine.{k}": "counter" for k in GRAPH_STATS},
                 "engine.decode_graph_capture_ms": "hist"}


def is_port(obj) -> bool:
    """Whether ``obj`` (an engine, scheduler or session) is the port's."""
    return type(obj).__module__.startswith("repro_torch.")


def shared_stats(owner, st: dict) -> dict:
    """``st`` (``owner.stats()``: an engine's, or a scheduler's over one)
    without the port's decode-graph keys."""
    port = is_port(owner)
    assert all((k in st) == port for k in GRAPH_STATS), sorted(st)
    return {k: v for k, v in st.items() if k not in GRAPH_STATS}


def shared_counters(port: bool, counters: dict) -> dict:
    """A metrics snapshot's counters without the port's decode-graph
    counters."""
    names = [n for n, kind in GRAPH_METRICS.items() if kind == "counter"]
    assert all((n in counters) == port for n in names), sorted(counters)
    return {k: v for k, v in counters.items() if k not in names}


def shared_metric_lines(port: bool, lines: list) -> list:
    """Metrics text lines (``<kind> <name> ...``) without the port's
    decode-graph metrics of the kinds the lines hold."""
    kinds = {ln.split()[0] for ln in lines if ln.split()}
    names = {ln.split()[1] for ln in lines if len(ln.split()) > 1}
    assert all((n in names) == port for n, kind in GRAPH_METRICS.items()
               if kind in kinds), sorted(names)
    return [ln for ln in lines
            if len(ln.split()) < 2 or ln.split()[1] not in GRAPH_METRICS]
