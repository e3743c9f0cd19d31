"""The CUDA ``rglru_scan`` kernel's stage walk, modelled on the CPU.

``rglru_scan_kernel`` (``csrc/rglru_scan.cu``) gives each warp a tile of 32
channels and streams a and b through a ring of ``STAGES`` stages of
``STEPS`` steps: TMA writes each stage as a box with zeros past S and past
D, kStages - 1 stages ahead of the recurrence, and the warp runs one
multiply and one add a step (no fused multiply-add) over the stage it has
waited for.  :func:`stage_walk` does the same walk in PyTorch: the tiles,
the ring and its slots, the zero-filled boxes, and the step arithmetic.
It must equal ``rglru_scan_plain`` bit for bit (the kernel's promise on the
card) and the Pallas kernel in interpret mode within 1e-6 (JAX orders the
same multiply and add per step; the limit allows an ulp at |h| < 8).
Cases: ragged S and D, batch 2, bf16 inputs, and small stages that wrap the
ring many times.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import rglru_scan as jrglru_scan
from repro_torch.kernels import rglru_scan as RS

torch.set_num_threads(2)

CHAN, STEPS, STAGES = 32, 64, 4      # csrc/rglru_scan.cu kChan, kSteps, kStages


def stage_walk(a, b, *, chan=CHAN, steps=STEPS, stages=STAGES):
    """h (B, S, D) f32 as the kernel computes it, tile by tile and stage by
    stage through the ring."""
    Bn, S, D = a.shape
    h = torch.full((Bn, S, D), float("nan"))
    n_stages = -(-S // steps)
    for bi in range(Bn):
        for d0 in range(0, D, chan):
            cols = min(chan, D - d0)
            ring_a = torch.full((stages, steps, chan), float("nan"), dtype=a.dtype)
            ring_b = torch.full((stages, steps, chan), float("nan"), dtype=b.dtype)
            filled = [None] * stages

            def load(k):                 # one TMA box per input, zeros past S and D
                slot, t0 = k % stages, k * steps
                rows = min(steps, S - t0)
                for ring, src in ((ring_a, a), (ring_b, b)):
                    ring[slot].zero_()
                    ring[slot, :rows, :cols] = src[bi, t0:t0 + rows, d0:d0 + cols]
                filled[slot] = k

            for k in range(min(stages - 1, n_stages)):
                load(k)
            hv = torch.zeros(chan)
            for k in range(n_stages):
                if k + stages - 1 < n_stages:
                    load(k + stages - 1)
                slot, t0 = k % stages, k * steps
                assert filled[slot] == k, "a slot was refilled before it was read"
                for r in range(min(steps, S - t0)):
                    hv = ring_a[slot, r].float() * hv      # rounded product
                    hv = hv + ring_b[slot, r].float()      # then rounded sum
                    h[bi, t0 + r, d0:d0 + cols] = hv[:cols]
    return h


def _inputs(B, S, D, dtype, seed):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-(rng.standard_normal((B, S, D), dtype=np.float32) + 2.0)))
    b = rng.standard_normal((B, S, D), dtype=np.float32) * 0.3
    return torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)


# (B, S, D, steps, stages)
CASES = {
    "one_tile_whole_stages": (1, 256, 32, STEPS, STAGES),
    "ragged_s_and_d": (1, 300, 70, STEPS, STAGES),
    "batch2_ragged": (2, 130, 40, STEPS, STAGES),
    "fewer_stages_than_the_ring": (1, 100, 33, STEPS, STAGES),
    "small_stages_wrap_the_ring": (2, 75, 45, 8, 3),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_stage_walk_equals_plain_and_pallas(name, dtype):
    B, S, D, steps, stages = CASES[name]
    a, b = _inputs(B, S, D, dtype, seed=len(name))
    got = stage_walk(a, b, steps=steps, stages=stages)
    assert not torch.isnan(got).any()
    assert torch.equal(got, RS.rglru_scan_plain(a, b))
    assert torch.equal(got, RS.rglru_scan(a, b))           # the CPU op: the plain version
    ja, jb = (jnp.asarray(t.float().numpy()).astype(jnp.dtype(str(dtype)[6:])) for t in (a, b))
    want = np.asarray(jrglru_scan(ja, jb, chunk=S, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
