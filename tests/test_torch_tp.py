"""Port parity: tensor-parallel serving (``ServeEngine(tp=)``/``mesh=``) on
the CPU.

The JAX package's tp tests (``tests/test_distributed.py``,
``tests/test_serve_fast_path.py::test_tp2_fused_token_parity_subprocess``)
fail on the installed JAX inside ``Model.prefill`` (a sharded ``q``
reshape), so the port's tp engine is held against the reference's
*single-device* engine, whose claim the tp engine must meet: token
identity.  Both run from one set of weights (the reference's
``Model.init(PRNGKey(0))`` through numpy and ``params_from_jax``) on
``paper-agentic`` at float32 with 2 layers (the reference tests' cut), the
port's shards all on the CPU (``device="cpu"``: the kernels' plain
versions), the JAX engine on ``attn_impl="fused_ref"`` (or ``"ref"``).
Greedy tokens and CoW counters must be identical; step and verify logits
agree within 1e-4 (float32 on both sides; the tp sums add the shards'
partial products in another order than one product does).  The other
families the engine serves (qwen2-1.5b, nemotron, granite, stablelm,
dbrx, pixtral) join the first test at tp 2, ``reduced()`` at 4 heads over
2 kv heads, from the port's seeded init handed to the reference as jnp
arrays; an engine given its shards already placed (drawn shard by shard
for dbrx) serves as the whole tree and the reference do.  Sampled runs
draw from different streams in the two packages: tp 2 is held against
the port's tp 1 there (identical), and against the reference on
structure.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from jax.sharding import PartitionSpec as P

import repro.runtime.serve_loop as jax_serve
import repro.server as jax_server
import repro_torch.server as port_server
from repro.api import BranchSession as JaxSession
from repro.configs import get_config
from repro.configs.base import reduced
from repro.distributed import sharding as jax_sharding
from repro.models.model import Model as JaxModel
from repro_torch.api import BranchSession
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import reduced as port_reduced
from repro_torch.distributed import (
    DeviceMesh,
    ParallelPlan,
    kv_page_spec,
    sanitize,
    serve_param_specs,
    serving_mesh,
    serving_plan,
    shard_params,
)
from repro_torch.models import Model
from repro_torch.runtime import ServeEngine
from repro_torch.runtime import serve_loop as port_serve

TOL = 1e-4
#: the port's engine options of each path, and the JAX engine's
PATHS = {"fused": {}, "ref": {"attn_impl": "ref"},
         "int8": {"kv_dtype": "int8"}}
JAX_PATHS = {"fused": {"attn_impl": "fused_ref"}, "ref": {"attn_impl": "ref"},
             "int8": {"attn_impl": "fused_ref", "kv_dtype": "int8"}}
GEOMETRY = dict(num_pages=64, page_size=4, max_pages_per_seq=16)
#: a verify's four drafts of four tokens
TP_DRAFTS = [[1, 2, 3, 4], [4, 3, 2, 1], [7, 7, 7, 7], [9, 8, 7, 6]]


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(get_config("paper-agentic"), dtype="float32",
                               num_layers=2)
    pcfg = dataclasses.replace(port_config("paper-agentic"), dtype="float32",
                               num_layers=2)
    jmodel = JaxModel(jcfg, attn_chunk=8, remat=False)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, Model(pcfg), pparams


def port_engine(setup, tp=None, **kw):
    """The port's engine: ``tp`` shards on the CPU (unset: one shard)."""
    _, _, pmodel, pparams = setup
    return ServeEngine(pmodel, pparams, device="cpu", tp=tp,
                       **{**GEOMETRY, **kw})


def jax_engine(setup, **kw):
    jmodel, jparams, _, _ = setup
    return jax_serve.ServeEngine(jmodel, jparams, **{**GEOMETRY, **kw})


def cycle(eng):
    """``tests/test_distributed.py::test_tp_serving_matches_single_device``'s
    cycle: decode, fork 2 (lazy CoW: faults on the next step), 3 steps,
    commit one (its sibling invalidated), one more step."""
    sid = eng.add_request([1, 2, 3, 4, 5])
    toks = [eng.decode([sid])]
    kids = eng.fork(sid, 2)
    for _ in range(3):
        toks.append(eng.decode(kids))
    parent = eng.commit(kids[0])
    toks.append(eng.decode([parent]))
    return toks, eng.cow_dispatches, eng.cow_faults


@pytest.fixture(scope="module")
def reference_cycles(setup):
    """The JAX single-device engine's cycle on each path, once."""
    return {path: cycle(jax_engine(setup, **kw))
            for path, kw in JAX_PATHS.items()}


#: the other families at tp 2: ``reduced()`` at 4 heads over 2 kv heads in
#: float32 (qwen2-1.5b: qkv bias and a tied head; nemotron: sqrelu; dbrx:
#: geglu experts) on the fused path; the ``"ref"`` and int8 paths on one
#: (they change only the decode attention and the pools, whose shapes the
#: families share at these widths; ``paper-agentic`` holds them at tp 1,
#: 2 and 4)
FAMILIES = ("qwen2-1.5b", "nemotron-4-15b", "granite-8b", "stablelm-12b",
            "dbrx-132b", "pixtral-12b")
ALL_PATHS_FAMILY = "qwen2-1.5b"
SERVING_CASES = (
    [pytest.param("paper-agentic", path, tp, id=f"{path}-{tp}")
     for path in sorted(PATHS) for tp in (1, 2, 4)]
    + [pytest.param(arch, path, 2, id=f"{arch}-{path}-2")
       for arch in FAMILIES
       for path in (PATHS if arch == ALL_PATHS_FAMILY else ("fused",))])


def family_setup(arch):
    """``setup``'s four for a family: the port's seeded init, handed to the
    reference as jnp arrays (its own init would add a compile)."""
    kw = dict(dtype="float32", num_heads=4, num_kv_heads=2)
    jcfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    pcfg = dataclasses.replace(port_reduced(port_config(arch)), **kw)
    pparams = Model(pcfg).init(torch.Generator().manual_seed(0))
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()),
                                     pparams)
    return (JaxModel(jcfg, attn_chunk=8, remat=False), jparams, Model(pcfg),
            pparams)


def family_cycle(eng):
    """A shorter cycle (one compiled batch size): fork 2 off the prompt
    (lazy CoW), 3 steps of both branches, commit one."""
    sid = eng.add_request([1, 2, 3, 4, 5, 6])   # 5 cached: a shared tail
    kids = eng.fork(sid, 2)
    toks = [eng.decode(kids) for _ in range(3)]
    eng.commit(kids[0])
    return toks, eng.cow_dispatches, eng.cow_faults


@pytest.fixture(scope="module")
def serving_runs(setup, reference_cycles):
    """(weights, cycle, the reference's single-device cycle) of a config
    and path, each made once: ``paper-agentic``'s from the fixtures above,
    each family's from :func:`family_setup`."""
    made = {"paper-agentic": (setup, cycle, reference_cycles)}

    def get(arch, path):
        if arch not in made:
            made[arch] = (family_setup(arch), family_cycle, {})
        fam, run, refs = made[arch]
        if path not in refs:
            refs[path] = run(jax_engine(fam, **JAX_PATHS[path]))
        return fam, run, refs[path]
    return get


@pytest.mark.parametrize("arch, path, tp", SERVING_CASES)
def test_tp_serving_matches_single_device(serving_runs, arch, path, tp):
    """tp 1, 2 and 4 of ``paper-agentic`` (kv heads 4, 2 and 1 a shard),
    and tp 2 of the other families (:data:`FAMILIES`), are token-identical
    to the reference's single-device engine and to the port's one shard,
    CoW counters included, on the fused, ``"ref"`` and int8 paths."""
    fam, run, want = serving_runs(arch, path)
    eng = port_engine(fam, tp=tp, **PATHS[path])
    got = run(eng)
    kv = fam[2].cfg.num_kv_heads
    assert eng.tp == eng.stats()["tp"] == len(eng.shards) == tp
    assert [sh.k_pages.shape[3] for sh in eng.shards] == [kv // tp] * tp
    assert got == want
    assert got == run(port_engine(fam, **PATHS[path]))
    assert got[2] > 0 and got[1] == (1 if path == "ref" else 0)


def verify_rows(eng):
    """A 4x4 verify over a forked branch: its rows and the CoW counters
    (the pass writes no pool, so it faults nothing)."""
    sid = eng.add_request([9, 8, 7, 6, 5, 4, 3])
    (branch,) = eng.fork(sid, 1)
    return (eng.spec_verify(branch, TP_DRAFTS), eng.cow_dispatches,
            eng.cow_faults)


@pytest.mark.parametrize("arch", ["paper-agentic", "dbrx-132b"])
def test_placed_shards_serve_as_the_whole_tree(serving_runs, arch):
    """An engine given one tree per shard, already placed (``paper-
    agentic``: placed copies of the reference's weights' shards;
    ``dbrx-132b``: the port's seeded init drawn shard by shard), keeps
    those tensors and serves token for token, CoW counters included, as
    the reference's single device and tp 2 cut from the whole tree, and
    verifies as the latter (which ``test_tp2_verify_rows_match_the_
    reference`` holds to the reference)."""
    fam, run, want = serving_runs(arch, "fused")
    model, whole = fam[2], fam[3]
    plan = serving_plan(serving_mesh(2, ["cpu"] * 2))
    if arch == "paper-agentic":
        shards = [pytree.tree_map(torch.clone, t)
                  for t in shard_params(model.cfg, plan, whole)]
    else:
        shards = model.init(torch.Generator().manual_seed(0), shards=plan)
    eng = ServeEngine(model, shards, mesh=plan.mesh, **GEOMETRY)
    assert all(sh.params is tree for sh, tree in zip(eng.shards, shards))
    got = run(eng)
    assert got == want == run(port_engine(fam, tp=2))
    rows = verify_rows(ServeEngine(model, shards, mesh=plan.mesh,
                                   **GEOMETRY))
    assert rows == verify_rows(port_engine(fam, tp=2))


def spy_logits(monkeypatch, method):
    """Record the logits every call of ``ServeEngine.<method>`` returns."""
    seen = []
    original = getattr(ServeEngine, method)

    def spy(self, *args, **kw):
        out = original(self, *args, **kw)
        if isinstance(out, torch.Tensor):
            seen.append(out.numpy().copy())
        return out
    monkeypatch.setattr(ServeEngine, method, spy)
    return seen


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("path", ["fused", "ref"])
def test_tp_step_logits_match(setup, monkeypatch, path, tp):
    """Every step's logits at tp 2 and 4 within 1e-4 of one shard's (the
    step the single-device test above holds to the reference's)."""
    method = "_legacy_decode_step" if path == "ref" else "_fused_decode_step"
    seen = spy_logits(monkeypatch, method)
    cycle(port_engine(setup, **PATHS[path]))
    one = list(seen)
    seen.clear()
    cycle(port_engine(setup, tp=tp, **PATHS[path]))
    assert len(seen) == len(one) == 5
    for a, b in zip(seen, one):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def fast_path_run(eng):
    """``test_serve_fast_path.py::test_tp2_fused_token_parity_subprocess``:
    a 13-token prompt, decode, fork 2, two steps, a verify of 2 drafts."""
    sid = eng.add_request(list(range(1, 14)))
    out = eng.decode([sid])
    kids = eng.fork(sid, 2)
    out += eng.decode(kids)
    out += eng.decode(kids)
    ver = eng.spec_verify(kids[0], [[5, 6, 7], [1, 2, 3]])
    assert eng.cow_dispatches == 0
    return out, ver


def test_tp2_fused_decode_and_verify_token_parity(setup, monkeypatch):
    """tp 2 fused decode and verify equal the reference's single device
    token for token; the verify logits within 1e-4 of one shard's."""
    seen = spy_logits(monkeypatch, "_chunk_pass")
    ref = fast_path_run(jax_engine(setup, attn_impl="fused_ref"))
    got = {tp: fast_path_run(port_engine(setup, tp=tp)) for tp in (None, 2)}
    assert got[2] == got[None] == ref
    assert len(seen) == 2
    assert seen[0].shape == (2, 3, setup[2].cfg.vocab_size)
    np.testing.assert_allclose(seen[1], seen[0], rtol=TOL, atol=TOL)


def test_tp2_verify_rows_match_the_reference(setup):
    """A 4x4 verify over a forked branch: rows identical to the
    reference's; the pass leaves every pool untouched."""
    rows = {}
    for name, eng in (("jax", jax_engine(setup, attn_impl="fused_ref")),
                      ("port", port_engine(setup, tp=2))):
        sid = eng.add_request([9, 8, 7, 6, 5, 4, 3])
        (branch,) = eng.fork(sid, 1)
        greedy = [eng.decode([branch])[0] for _ in range(4)]
        drafts = [greedy, [greedy[0], 0, 1, 2], [0, 1, 2, 3], [3, 2, 1, 0]]
        if name == "port":
            before = [p.clone() for sh in eng.shards for p in sh.pools()
                      if p is not None]
        rows[name] = eng.spec_verify(sid, drafts)
        assert eng.verify_dispatches == 1
        assert rows[name][0] == greedy
    after = [p for sh in eng.shards for p in sh.pools() if p is not None]
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert rows["port"] == rows["jax"]


def test_tp_prefix_cache_suffix_prefill(setup):
    """A page-aligned shared head at tp 2: the second prompt prefills only
    its suffix (each shard's suffix K/V scattered into its own pools), the
    repeat prefills nothing; tokens equal the reference's."""
    head = list(range(3, 3 + 12))                # three full pages
    prompts = [head + [40, 41, 42, 43, 44, 45], head + [50, 51, 52, 53, 54],
               head + [40, 41, 42, 43, 44, 45]]
    tokens = {}
    engines = {"jax": jax_engine(setup, attn_impl="fused_ref",
                                 prefix_cache=True),
               "port": port_engine(setup, tp=2, prefix_cache=True),
               "one": port_engine(setup, prefix_cache=True)}
    for name, eng in engines.items():
        sids = [eng.add_request(p) for p in prompts]
        out = eng.decode(sids)
        out += eng.decode(sids)
        tokens[name] = out
        assert eng.prefill_dispatches == 2
    assert tokens["port"] == tokens["jax"] == tokens["one"]


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_tp_checkpoint_restore(setup, kv_dtype):
    """A tp 2 branch demoted to the tier (the shards' kv-head slices
    concatenated) and restored into other pages continues as the
    reference's does; its snapshot holds the whole kv-head dim, within
    1e-4 of one shard's (int8: the same pages and scales within one
    quantization step)."""
    tokens, snaps = {}, {}
    engines = {"jax": jax_engine(setup, tier_host_bytes=1,
                                 **JAX_PATHS["int8" if kv_dtype else
                                             "fused"]),
               "port": port_engine(setup, tp=2, kv_dtype=kv_dtype,
                                   tier_host_bytes=1),
               "one": port_engine(setup, kv_dtype=kv_dtype,
                                  tier_host_bytes=1)}
    for name, eng in engines.items():
        sid = eng.add_request([5, 17, 3, 42, 7, 11, 2, 9, 30, 4, 8, 1, 22])
        out = eng.decode([sid])
        freed = eng.checkpoint(sid)
        if name != "jax":
            snaps[name] = eng.tier.get(sid)
        other = eng.add_request([7] * 30)        # reuses the freed pages
        out += eng.decode([other])
        eng.release(other)
        eng.restore(sid)
        out += [eng.decode([sid])[0] for _ in range(3)]
        tokens[name] = (out, freed)
    assert tokens["port"] == tokens["jax"] == tokens["one"]
    a, b = snaps["port"], snaps["one"]
    assert a.k_pages.shape == b.k_pages.shape
    assert a.k_pages.shape[3] == setup[2].cfg.num_kv_heads
    if kv_dtype is None:
        np.testing.assert_allclose(a.k_pages, b.k_pages, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(a.v_pages, b.v_pages, rtol=TOL, atol=TOL)
    else:
        np.testing.assert_allclose(a.k_scales, b.k_scales, rtol=TOL)
        assert np.abs(a.k_pages.astype(int) - b.k_pages).max() <= 1


def test_tp_eager_cow_fork_services_each_shard(setup):
    """An eager fan-out copies each shard's slice of the faulted page in
    one dispatch; the copies equal their sources on every shard."""
    eng = port_engine(setup, tp=2)
    sid = eng.add_request([1, 2, 3, 4, 5, 6])
    src = eng.kv.block_table(sid)[-1]
    kids = eng.fork(sid, 3, eager_cow=True)
    assert eng.cow_dispatches == 1 and eng.cow_faults == 3
    for kid in kids:
        dst = eng.kv.block_table(kid)[-1]
        assert dst != src
        for sh in eng.shards:
            assert torch.equal(sh.k_pages[:, dst], sh.k_pages[:, src])
            assert torch.equal(sh.v_pages[:, dst], sh.v_pages[:, src])


def session_cycle(session):
    """``test_tp_session_sampled_exploration_matches_single_device``: a
    vectorized branch() of 3 sampled at temperature 2, wait for 4 tokens,
    commit one, finish."""
    root = session.open([1, 2, 3, 4, 5], max_new_tokens=12)
    kids = session.branch(root, n=3)
    for hd in kids:
        session.resume(hd, greedy=False, temperature=2.0)
    session.wait(kids, produced=4)
    tails = [tuple(session.tokens(hd)) for hd in kids]
    session.commit(kids[1])
    out = session.finish(root)
    return tails, out


def test_tp_session_sampled_exploration_matches_single_device(setup):
    """The API stack over a tp 2 engine with temperature sampling gives
    tp 1's tails and output (one seed, one stream on shard 0's device);
    the reference's session has the same structure."""
    runs = {}
    for tp in (1, 2):
        eng = port_engine(setup, tp=tp)
        session = BranchSession(eng, max_batch=8, seed=7)
        runs[tp] = session_cycle(session) + (
            eng.cow_dispatches, session.tp, session.sched.tp,
            session.tree()["scheduler"]["tp"])
    assert runs[1][3:] == (1, 1, 1) and runs[2][3:] == (2, 2, 2)
    assert runs[1][:3] == runs[2][:3]
    jeng = jax_engine(setup)
    jtails, jout = session_cycle(JaxSession(jeng, max_batch=8, seed=7))
    assert [len(t) for t in jtails] == [len(t) for t in runs[2][0]]
    assert len(jout) == len(runs[2][1])
    assert jeng.cow_dispatches == runs[2][2]


def test_tp_engine_rejects_nondividing_mesh(setup):
    """Heads 6 over kv 3 cannot split 2 ways: the reference refuses (it
    names ``num_kv_heads``), the port runs the attention block whole on
    each shard (its pools whole too) and adds it once, token-identical to
    one shard, as the reference's ``sanitize`` replicates such leaves in
    training (ROADMAP §3, uneven head splits); a d_ff the MLP's sum runs
    over must still divide.  A tp that contradicts the mesh, a mesh with
    device=, a mesh without a tp axis and more shards than visible cards
    raise."""
    jcfg = dataclasses.replace(setup[0].cfg, num_heads=6, num_kv_heads=3,
                               head_dim=32)
    pcfg = dataclasses.replace(setup[2].cfg, num_heads=6, num_kv_heads=3,
                               head_dim=32)
    with pytest.raises(ValueError, match="num_kv_heads"):
        jax_serve.ServeEngine._check_tp_divisibility(jcfg, 2)
    model = Model(pcfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = []
    for tp in (None, 2):
        eng = ServeEngine(model, params, num_pages=16, page_size=4, tp=tp,
                          device="cpu")
        seq = eng.add_request([5, 9, 2, 7])
        tokens.append([eng.decode([seq], greedy=True) for _ in range(3)])
    assert tokens[0] == tokens[1] and eng.kv_tp == 1
    odd = Model(dataclasses.replace(pcfg, d_ff=1023))
    with pytest.raises(ValueError, match="d_ff"):
        ServeEngine(odd, odd.init(torch.Generator().manual_seed(0)),
                    num_pages=16, page_size=4, tp=2, device="cpu")
    _, _, pmodel, pparams = setup
    mesh = serving_mesh(2, ["cpu"] * 2)
    with pytest.raises(ValueError, match="contradicts"):
        ServeEngine(pmodel, pparams, mesh=mesh, tp=4)
    with pytest.raises(ValueError, match="not both"):
        ServeEngine(pmodel, pparams, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="'tp' or 'model'"):
        ServeEngine(pmodel, pparams, mesh=DeviceMesh(["cpu"] * 2, ("data",)))
    with pytest.raises(ValueError, match="visible CUDA devices"):
        serving_mesh(torch.cuda.device_count() + 1)


def test_mesh_argument_and_model_axis(setup):
    """``mesh=`` with an explicit (repeating) device list, and a 2-D
    data x model mesh whose model axis serves (the batch replicated over
    data), give the tp= engine's tokens."""
    _, _, pmodel, pparams = setup
    want = cycle(port_engine(setup, tp=2))
    eng = ServeEngine(pmodel, pparams, mesh=serving_mesh(2, ["cpu", "cpu"]),
                      **GEOMETRY)
    assert cycle(eng) == want and eng.devices == (torch.device("cpu"),) * 2
    grid = DeviceMesh([["cpu", "cpu"], ["cpu", "cpu"]], ("data", "model"))
    eng = ServeEngine(pmodel, pparams, mesh=grid, **GEOMETRY)
    assert eng.tp == 2 and eng.plan.tp_axis == "model"
    assert cycle(eng) == want


class FakePlan:
    """A plan whose mesh reports axis sizes without the devices (the
    reference's sanitize test)."""

    def __init__(self, shape, tp_axis=None):
        self.mesh = type("M", (), {"shape": shape})()
        self.tp_axis = tp_axis


def padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


@pytest.mark.parametrize("spec, shape", [
    ((None, "model"), (28, 8)), ((None, "model"), (28, 32)),
    ((("pod", "data"), None), (128, 4)), ((("pod", "data"), None), (1, 4)),
    (("data",), (16, 3)), (("model", None, "data"), (32, 3, 48))])
def test_sanitize_drops_nondividing_axes(spec, shape):
    """The reference test's cases (kv 8 cannot shard 16 ways, heads 32
    can, the (pod, data) tuple must divide the batch), each equal to the
    reference's ``sanitize`` on the same plan."""
    plan = FakePlan({"model": 16, "data": 16, "pod": 2})
    got = sanitize(plan, spec, shape)
    assert got == padded(jax_sharding.sanitize(plan, P(*spec), shape),
                         len(shape))
    assert len(got) == len(shape)
    assert sanitize(plan, (None, "model"), (28, 8)) == (None, None)
    assert sanitize(plan, (None, "model"), (28, 32)) == (None, "model")


def moe_params(seed=0):
    jcfg = dataclasses.replace(
        reduced(get_config("qwen3-moe-235b-a22b"), d_model=64),
        dtype="float32", num_experts=4, experts_per_token=2, num_kv_heads=2)
    jparams = JaxModel(jcfg, attn_chunk=8, remat=False).init(
        jax.random.PRNGKey(seed))
    return jcfg, jax.tree_util.tree_map(np.asarray, jparams)


@pytest.mark.parametrize("name", ["paper-agentic", "qwen2-1.5b", "moe"])
def test_serve_param_specs_match_the_reference(setup, name):
    """``serve_param_specs`` leaf by leaf against the reference's on a plan
    that reports a tp width of 2; ``shard_params`` cuts each leaf along
    that dim (the shards concatenate back to the leaf) and shares the
    replicated leaves."""
    if name == "moe":
        jcfg, weights = moe_params()
    else:
        jcfg = dataclasses.replace(get_config(name), dtype="float32",
                                   num_layers=2)
        if name == "qwen2-1.5b":
            jcfg = dataclasses.replace(reduced(jcfg), tie_embeddings=True,
                                       qkv_bias=True)
        weights = jax.tree_util.tree_map(
            np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    pcfg = dataclasses.replace(port_config(jcfg.name), **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    params = params_from_jax(weights, device="cpu")
    jspecs = jax_sharding.serve_param_specs(
        jcfg, FakePlan({"tp": 2}, "tp"), weights)
    plan = ParallelPlan(mesh=serving_mesh(2, ["cpu"] * 2), tp_axis="tp")
    pspecs = serve_param_specs(pcfg, plan, params)
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda s: isinstance(s, P))[0]
    assert len(flat) > 5
    shards = shard_params(pcfg, plan, params)
    for path, jspec in flat:
        keys = tuple(k.key for k in path)
        leaf, pspec = params, pspecs
        for k in keys:
            leaf, pspec = leaf[k], pspec[k]
        assert pspec == padded(jspec, leaf.dim()), keys
        parts = []
        for tree in shards:
            for k in keys:
                tree = tree[k]
            parts.append(tree)
        if "tp" in pspec:
            dim = pspec.index("tp")
            assert torch.equal(torch.cat(parts, dim), leaf), keys
            assert parts[0].shape[dim] == leaf.shape[dim] // 2
        else:
            assert all(p is leaf for p in parts), keys   # no copy
    assert kv_page_spec(plan) == (None, None, None, "tp", None)
    assert port_serve.scale_spec(plan) == (None, None, "tp")
    assert serving_plan(None).devices == () and plan.tp_size == 2


@pytest.mark.parametrize("path", ["fused", "ref"])
def test_tp4_kernels_take_one_kv_head_a_shard(setup, monkeypatch, path):
    """At tp 4 (kv 4, heads 8) every attention call sees one kv head and
    its group of 2 (the dense prefill's flash attention: 2 heads over 1),
    once per shard and layer of each pass."""
    #: each wrapper's argument that carries the kv-head dim
    kv_arg = {"flash_attention": 1, "paged_attention": 1,
              "paged_chunk_attention": 3}
    shapes = {name: [] for name in kv_arg}
    for name in kv_arg:
        def spy(*args, _name=name, _fn=getattr(port_serve, name)):
            shapes[_name].append((tuple(args[0].shape),
                                  tuple(args[kv_arg[_name]].shape[-2:])))
            return _fn(*args)
        monkeypatch.setattr(port_serve, name, spy)
    eng = port_engine(setup, tp=4, **PATHS[path])
    sid = eng.add_request([1, 2, 3, 4, 5, 6])
    eng.decode(eng.fork(sid, 3))
    hd, nl = setup[2].cfg.head_dim, setup[2].cfg.num_layers
    assert shapes["flash_attention"] == [((1, 5, 2, hd), (1, hd))] * (4 * nl)
    if path == "ref":
        step, other, q = "paged_attention", "paged_chunk_attention", (3, 1,
                                                                      2, hd)
    else:
        step, other, q = "paged_chunk_attention", "paged_attention", (3, 1,
                                                                      1, 2,
                                                                      hd)
    assert shapes[step] == [(q, (1, hd))] * (4 * nl)
    assert not shapes[other]


def served(session, server):
    """A greedy ``/v1/generate`` stream and a best-of-3 ``/v1/explore``
    through ``server.FrontDoor`` over ``session``, drained after."""
    async def run():
        fd = server.FrontDoor(session, [])
        await fd.start_backend()
        try:
            resp = await fd.dispatch("POST", "/v1/generate", {
                "prompt": [1, 2, 3], "max_new_tokens": 6})
            events = [(e, d) async for e, d in resp.events]
            explore = await fd.dispatch("POST", "/v1/explore", {
                "prompt": [4, 5, 6], "policy": "best_of_n",
                "params": {"n": 3, "tokens": 3}, "stream": False})
            return events, explore.status, explore.body
        finally:
            await fd.shutdown(drain=True, timeout=60)
    return asyncio.run(run())


def test_front_door_serves_a_tp_engine(setup):
    """The HTTP/SSE front door over a tp 2 engine, unchanged: the greedy
    stream's events and tokens are the reference's over its single
    device; a best-of-3 exploration commits one winner and the pool
    drains."""
    eng = port_engine(setup, tp=2, num_pages=128)
    session = BranchSession(eng, max_batch=8, seed=11)
    events, status, body = served(session, port_server)
    jevents, jstatus, jbody = served(
        JaxSession(jax_engine(setup, attn_impl="fused_ref", num_pages=128),
                   max_batch=8, seed=11), jax_server)
    assert [e for e, _ in events] == [e for e, _ in jevents]
    assert events[-1][1]["generated"] == jevents[-1][1]["generated"]
    assert status == jstatus == 200
    assert body["result"]["committed"] and jbody["result"]["committed"]
    st = eng.stats()
    assert st["tp"] == 2 and st["sequences_live"] == 0
    assert st["pages_free"] + st["prefix_pages_cached"] == st["pages_total"]
