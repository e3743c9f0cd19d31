"""The bf16 CUDA ``ssd_scan`` kernel's walk, modelled on the CPU.

``ssd_scan_mma_kernel`` (``csrc/ssd_scan.cu``) gives each block one head's
32 head-dim columns and walks the chunks in order with the state in f32
registers.  Each chunk is a fixed tile of 128 rows (zeros past the chunk,
past s, past n and past p; dt 0 there), and its products run on the tensor
cores in bf16 with f32 sums: C Bᵀ exact; the score block S = C Bᵀ ∘ L ∘ dt
per 16 x 16 block on and below the diagonal, as bf16 hi + lo; the carried
state as hi + lo in C stateᵀ; and x ∘ w as hi + lo in the state update.
The owners of row tiles 4..7 sum blocks 0..3 and a helper warp the rest.

:func:`mma_walk` does that walk in PyTorch (float32 products of bf16
values, rounded to hi + lo exactly as the kernel rounds), with L as
``exp2`` of a_cum · log2(e) (the kernel's ``ex2.approx`` differs from it
by about 2^-22 relative).  It is held against ``ssd_scan_plain`` and the
Pallas kernel in interpret mode:

* float32 inputs, the walk without the hi + lo rounding (the tiles, the p
  split and the padding alone): 1e-5 (max |want| + |want|), relative to
  the output's scale and to the element (the two sum in another order);
* bf16 inputs: y within PERF.md §2's bf16 limit, 2e-3 + 2^-7 |want|, and
  the state within the f32 one; and, before y is rounded to bf16, the
  walk's f32 y within 2^-12 max |y| of the plain version's f32 y on the
  same bf16 values: far below half a unit of bf16 (2^-9 relative), which
  is what the hi + lo operands are for.  Rounding S alone to bf16 misses
  that bound; the test shows it.

Cases: a ragged last chunk, batch 2, the reduced config's p 16 / n 16 /
chunk 16 (tiles mostly padding), and Mamba-2's own dt and A init.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro_torch.kernels import ssd_scan as SS

torch.set_num_threads(2)

TILE_Q, TILE_N, TILE_P, BLOCK = 128, 128, 32, 16   # kQ, kN, kPB, the mma tile
LOG2E = 1.4426950408889634
BF16_LIMIT = (2e-3, 2.0 ** -7)


def hi_lo(v):
    """f32 -> (hi, lo), both bf16 values held in f32, v ~= hi + lo."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def mma_walk(x, dt, A, B, C, chunk, *, split=True, s_hi_only=False):
    """(y f32 before its rounding, final state f32) as the bf16 kernel
    computes them.  ``split=False``: every operand in f32 (the tile walk
    alone); ``s_hi_only``: S rounded to bf16 without its lo part."""
    rnd = hi_lo if split else (lambda v: (v, torch.zeros_like(v)))
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    xf, Bf, Cf, dtf, Af = x.float(), B.float(), C.float(), dt.float(), A.float()
    y = torch.zeros((b, s, h, p))
    state_out = torch.zeros((b, h, p, n))
    for bi in range(b):
        for hh in range(h):
            for p0 in range(0, p, TILE_P):
                pw = min(TILE_P, p - p0)
                state = torch.zeros((TILE_P, TILE_N))
                st_hi, st_lo = rnd(state)
                for t0 in range(0, s, q):
                    rows = min(q, s - t0)
                    Ct, Bt = torch.zeros((TILE_Q, TILE_N)), torch.zeros((TILE_Q, TILE_N))
                    Xt, dtt = torch.zeros((TILE_Q, TILE_P)), torch.zeros(TILE_Q)
                    Ct[:rows, :n] = Cf[bi, t0:t0 + rows]
                    Bt[:rows, :n] = Bf[bi, t0:t0 + rows]
                    Xt[:rows, :pw] = xf[bi, t0:t0 + rows, hh, p0:p0 + pw]
                    dtt[:rows] = dtf[bi, t0:t0 + rows, hh]
                    acum = torch.cumsum(Af[hh] * dtt, 0)
                    acum2 = acum * LOG2E
                    a_end = acum[-1]
                    # y = exp(a_cum) (C stateᵀ), the state as hi + lo
                    yt = (Ct @ st_hi.T + Ct @ st_lo.T) * torch.exp(acum)[:, None]
                    helper = torch.zeros_like(yt)
                    for mt in range(TILE_Q // BLOCK):
                        i = slice(mt * BLOCK, (mt + 1) * BLOCK)
                        ii = torch.arange(mt * BLOCK, (mt + 1) * BLOCK)[:, None]
                        for kb in range(mt + 1):
                            j = slice(kb * BLOCK, (kb + 1) * BLOCK)
                            jj = torch.arange(kb * BLOCK, (kb + 1) * BLOCK)[None, :]
                            cb = Ct[i] @ Bt[j].T
                            seg = torch.where(jj <= ii, acum2[i][:, None] - acum2[j][None, :],
                                              0.0)
                            S = torch.where(jj <= ii, cb * torch.exp2(seg) * dtt[j][None, :],
                                            0.0)
                            s_hi, s_lo = rnd(S)
                            if s_hi_only:
                                s_lo = torch.zeros_like(s_lo)
                            part = s_hi @ Xt[j] + s_lo @ Xt[j]
                            if mt >= 4 and kb >= 4:      # a helper warp's block
                                helper[i] += part
                            else:
                                yt[i] += part
                    yt += helper
                    y[bi, t0:t0 + rows, hh, p0:p0 + pw] = yt[:rows, :pw]
                    # state = exp(a_end) state + (x ∘ w)ᵀ B, x ∘ w as hi + lo
                    wv = dtt * torch.exp(a_end - acum)
                    xw_hi, xw_lo = rnd(Xt * wv[:, None])
                    state = state * torch.exp(a_end) + xw_hi.T @ Bt
                    state = state + xw_lo.T @ Bt
                    st_hi, st_lo = rnd(state)
                state_out[bi, hh, p0:p0 + pw] = state[:pw, :n]
    return y, state_out


def _inputs(b, s, h, p, n, init, seed):
    """x, B and C as the SSM block hands them over (silu'd conv outputs),
    dt after softplus.  ``init="mamba2"``: Mamba-2's initialisation, dt
    log-uniform in [1e-3, 1e-1] and A = -U(1, 16) (arXiv:2405.21060)."""
    rng = np.random.default_rng(seed)
    silu = lambda v: v / (1.0 + np.exp(-v))
    x = silu(rng.standard_normal((b, s, h, p))).astype(np.float32)
    B = silu(rng.standard_normal((b, s, n))).astype(np.float32)
    C = silu(rng.standard_normal((b, s, n))).astype(np.float32)
    if init == "mamba2":
        dt = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1), (b, s, h)))
        A = -rng.uniform(1.0, 16.0, (h,))
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0))
        A = -np.exp(rng.uniform(0.0, 2.0, (h,)))
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in (x, dt, A, B, C)]


def _pallas(x, dt, A, B, C, chunk):
    jx, jB, jC = (jnp.asarray(t.float().numpy()).astype(jnp.dtype(str(t.dtype)[6:]))
                  for t in (x, B, C))
    out = jssd_scan(jx, jnp.asarray(dt.numpy()), jnp.asarray(A.numpy()), jB, jC,
                    chunk=chunk, interpret=True)
    return torch.from_numpy(np.array(out, np.float32))


# (b, s, h, p, n, chunk, init)
CASES = {
    "ragged_last_chunk": (1, 300, 1, 64, 128, 128, "wide"),
    "batch2": (2, 256, 1, 64, 128, 128, "wide"),
    "reduced_p16_n16_chunk16": (2, 48, 2, 16, 16, 16, "wide"),
    "mamba2_init": (1, 256, 2, 64, 128, 128, "mamba2"),
}


def _within(got, want, atol, rtol):
    err = (got - want).abs()
    return bool((err <= atol + rtol * want.abs()).all()), float(err.max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_tile_walk_matches_plain_and_pallas(name):
    b, s, h, p, n, chunk, init = CASES[name]
    x, dt, A, B, C = _inputs(b, s, h, p, n, init, seed=len(name))
    y, state = mma_walk(x, dt, A, B, C, chunk, split=False)
    y0, st0 = SS.ssd_scan_plain(x, dt, A, B, C, min(chunk, s))
    tol = 1e-5 * float(y0.abs().max())
    torch.testing.assert_close(y, y0, atol=tol, rtol=1e-5)
    torch.testing.assert_close(state, st0, atol=1e-5 * float(st0.abs().max()), rtol=1e-5)
    if s % chunk == 0:                                    # the Pallas wrapper's whole chunks
        torch.testing.assert_close(y, _pallas(x, dt, A, B, C, chunk), atol=tol, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_walk_holds_the_limits(name):
    b, s, h, p, n, chunk, init = CASES[name]
    x, dt, A, B, C = _inputs(b, s, h, p, n, init, seed=len(name))
    x, B, C = (t.to(torch.bfloat16) for t in (x, B, C))
    y, state = mma_walk(x, dt, A, B, C, chunk)
    # the plain version's f32 y on the same bf16 values, before rounding
    y32, st32 = SS.ssd_scan_plain(x.float(), dt, A, B.float(), C.float(), min(chunk, s))
    scale = float(y32.abs().max())
    assert float((y - y32).abs().max()) <= 2.0 ** -12 * scale
    torch.testing.assert_close(state, st32, atol=1e-5 * float(st32.abs().max()), rtol=0)
    y16, _ = SS.ssd_scan_plain(x, dt, A, B, C, min(chunk, s))
    ok, err = _within(y.to(torch.bfloat16).float(), y16.float(), *BF16_LIMIT)
    assert ok, f"bf16 y against the plain version: {err}"
    if s % chunk == 0:
        ok, err = _within(y.to(torch.bfloat16).float(), _pallas(x, dt, A, B, C, chunk),
                          *BF16_LIMIT)
        assert ok, f"bf16 y against the Pallas kernel: {err}"


def test_rounding_s_alone_to_bf16_misses_the_f32_bound():
    """Why S enters as hi + lo: its bf16 rounding alone puts y's f32 sum
    about 2^-9 from the plain version's, half a unit of y's own bf16."""
    b, s, h, p, n, chunk, init = CASES["mamba2_init"]
    x, dt, A, B, C = _inputs(b, s, h, p, n, init, seed=1)
    x, B, C = (t.to(torch.bfloat16) for t in (x, B, C))
    y32, _ = SS.ssd_scan_plain(x.float(), dt, A, B.float(), C.float(), chunk)
    y_hi, _ = mma_walk(x, dt, A, B, C, chunk, s_hi_only=True)
    assert float((y_hi - y32).abs().max()) > 2.0 ** -12 * float(y32.abs().max())
