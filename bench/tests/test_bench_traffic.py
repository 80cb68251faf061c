"""The traffic generator: one seed, one traffic; every seed the same sizes."""

from benchlib import files
from benchlib import traffic as T

MIXES = ("agent-long", "agent-small", "agent-tiny")


def _mix(name):
    return files.load_json(files.BENCH_DIR / "traffic" / f"{name}.json")


def _closed(p, seed, turns=3):
    gen = T.ClosedLoop(p, seed, 49152)
    out = []
    for s in range(gen.sessions):
        t = gen.first_turn(s)
        out.append((t.prompt, t.branch_tokens))
        for _ in range(turns):
            t = gen.next_turn(s, t.prompt + [7] * t.branch_tokens)
            out.append((t.prompt, t.branch_tokens))
    return out


def test_same_seed_same_traffic():
    for name in MIXES:
        p = _mix(name)
        assert _closed(p, 2 ** 31 + 12345) == _closed(p, 2 ** 31 + 12345)
        assert _closed(p, 2 ** 31 + 12345) != _closed(p, 7)


def test_every_seed_offers_the_same_sizes():
    for name in MIXES:
        p = _mix(name)
        x, y = _closed(p, 1), _closed(p, 2 ** 31 + 7)
        assert [(len(q), k) for q, k in x] == [(len(q), k) for q, k in y]
        assert [q for q, _ in x] != [q for q, _ in y]
    # a different base seed orders the same sizes otherwise
    p = _mix("agent-long")
    a, c = _closed(p, 1, 30), _closed(dict(p, base_seed=1), 1, 30)
    assert [len(q) for q, _ in c] != [len(q) for q, _ in a]


def test_sizes_within_the_mix():
    p = _mix("agent-long")
    gen = T.ClosedLoop(p, 3, 49152)
    for s in range(gen.sessions):
        t = gen.first_turn(s)
        for _ in range(30):
            assert t.prompt[:2048] == gen.system
            assert 32 <= t.branch_tokens <= 160
            assert len(t.prompt) + t.branch_tokens <= p["max_context_tokens"]
            t = gen.next_turn(s, t.prompt + [1] * t.branch_tokens)


def test_stratified_quantiles():
    v = T.stratified(1024, 8192, "loguniform", 8)
    assert v[0] > 1024 and v[-1] < 8192
    assert list(v) == sorted(v)
    assert list(T.stratified(0, 10, "uniform", 5)) == [1, 3, 5, 7, 9]
