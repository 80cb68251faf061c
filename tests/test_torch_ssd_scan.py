"""Port parity: the SSD scan's plain version against the JAX package.

The port's ``ssd_scan_ref`` (what the wrapper runs on the CPU, and what
the CUDA kernel is held against on the card) against the JAX Pallas kernel
in interpret mode, its jnp oracle ``ssd_scan_ref`` and ``ssd_chunked`` at
ragged lengths, where the JAX function falls back to a chunk of
``gcd(chunk, s)`` and the port pads the tail.  Inputs are drawn with numpy
from a seed, at the scales of ``tests/kernels/test_ssd_scan.py``.
Tolerance 1e-4, relative and absolute, as the JAX package's own sweep:
float32 on both sides, sums over up to a thousand tokens in different
orders and chunkings, outputs of magnitude up to ~50.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ref
from repro.models.ssm import ssd_chunked
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.ssm import ssd_decode_step

TOL = 1e-4


def make_case(seed, b, s, H, P, N):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, s, H, P)).astype(f),
            (np.log1p(np.exp(rng.standard_normal((b, s, H)))) * 0.5)
            .astype(f),
            (-np.exp(rng.standard_normal(H) * 0.3)).astype(f),
            rng.standard_normal((b, s, N)).astype(f),
            rng.standard_normal((b, s, N)).astype(f))


def port(case, chunk):
    y, st = ssd_scan_ref(*map(torch.from_numpy, case), chunk)
    return y.numpy(), st.numpy()


def close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)


# the sweep of tests/kernels/test_ssd_scan.py, f32 (b, s, H, P, N, chunk)
SWEEP = [(1, 64, 1, 64, 64, 16), (2, 128, 4, 64, 128, 32),
         (1, 128, 2, 128, 64, 64), (2, 64, 8, 64, 64, 64)]


@pytest.mark.parametrize("b,s,H,P,N,chunk", SWEEP, ids=str)
def test_matches_interpreted_kernel_and_oracle(b, s, H, P, N, chunk):
    case = make_case(s + H + P + N, b, s, H, P, N)
    got = port(case, chunk)
    jcase = [jnp.asarray(a) for a in case]
    close(got, ssd_scan_kernel(*jcase, chunk=chunk, interpret=True))
    close(got, jax_ref(*jcase, chunk))


@pytest.mark.parametrize("s", [13, 200, 1001])
def test_ragged_lengths_match_ssd_chunked(s):
    """The port pads the tail of the last 128-row chunk; the JAX function
    runs with chunk gcd(128, s) (1, 8 and 1 here): the same function."""
    case = make_case(s, 1, s, 2, 16, 8)
    close(port(case, 128), ssd_chunked(*map(jnp.asarray, case), 128))


def test_chunk_size_does_not_change_the_result():
    case = make_case(3, 2, 100, 2, 32, 32)
    close(port(case, 16), port(case, 128))


def test_matches_a_chain_of_decode_steps():
    x, dt, A, B, C = map(torch.from_numpy, make_case(4, 2, 37, 3, 16, 24))
    y_scan, st_scan = ssd_scan_ref(x, dt, A, B, C, 8)
    state = torch.zeros(2, 3, 24, 16)
    ys = []
    for t in range(37):
        y, state = ssd_decode_step(x[:, t], dt[:, t], A, B[:, t], C[:, t],
                                   state)
        ys.append(y)
    close((torch.stack(ys, 1).numpy(), state.numpy()),
          (y_scan.numpy(), st_scan.numpy()))


def test_decay_is_never_formed_above_the_diagonal():
    """Large dt * |A| makes exp(cum_q - cum_k) overflow to inf above the
    diagonal, and a mask applied as a product turns inf into NaN; the
    plain version forms the decay only on and below it."""
    x, dt, A, B, C = map(torch.from_numpy, make_case(5, 1, 64, 2, 16, 8))
    y, st = ssd_scan_ref(x, dt * 60.0, A * 10.0, B, C, 64)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


def test_bf16_rounds_once_and_keeps_f32_state():
    case = make_case(6, 1, 40, 2, 64, 64)
    x, dt, A, B, C = map(torch.from_numpy, case)
    y16, st16 = ssd_scan_ref(x.bfloat16(), dt, A, B.bfloat16(),
                             C.bfloat16(), 16)
    y32, st32 = ssd_scan_ref(x.bfloat16().float(), dt, A,
                             B.bfloat16().float(), C.bfloat16().float(), 16)
    assert y16.dtype == torch.bfloat16 and st16.dtype == torch.float32
    assert torch.equal(y16, y32.bfloat16()) and torch.equal(st16, st32)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    case = make_case(7, 1, 20, 2, 64, 64)
    before = ops.LAUNCHES[ops.NAME]
    y, st = ops.ssd_scan(*map(torch.from_numpy, case), chunk=8)
    close((y.numpy(), st.numpy()), port(case, 8))
    assert ops.LAUNCHES[ops.NAME] == before


def test_wrapper_validation_rejects_what_the_kernel_cannot_take():
    x, dt, A, B, C = map(torch.from_numpy, make_case(8, 1, 10, 2, 64, 64))
    ops._check(x, dt, A, B, C)                          # well formed
    with pytest.raises(ValueError, match="state dim"):
        ops._check(x, dt, A, B[..., :32].contiguous(), C[..., :32])
    with pytest.raises(ValueError, match="dt"):
        ops._check(x, dt.double(), A, B, C)
    strided = torch.empty(1, 64, 10).transpose(1, 2)     # [1, 10, 64]
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(x, dt, A, B, strided)
    with pytest.raises(TypeError):
        ops._check(x.double(), dt, A, B, C)
