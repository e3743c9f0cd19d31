"""A model of the bf16 attention kernel's shared-memory tiles on the CPU.

``csrc/chunked_attention.cu``'s ``Tile<HD>`` and ``WgmmaShape<HD>``: rows of
the widest swizzle atom (128, 64 or 32 bytes) that divides 2 hd bytes,
16-byte chunks XOR-swizzled by the row.  For every head dim the kernel
takes, every (row, chunk) of the tile lands on its own 16-byte slot and the
slots fill the tile exactly (hd 80 and 96 need no pad columns); and every
element that wgmma reads through the kernel's descriptors (Q and K as
K-major operands of S = Q K^T, V as the MN-major operand of each
warpgroup's P V) is the element the loader stored there.  The reads follow
the canonical swizzled layouts of the PTX ISA's wgmma matrix descriptors;
the plain versions at these head dims are held against the Pallas kernels
in ``tests/test_torch_chunked_attention.py``, and the card holds the
kernels against their plain versions (``chip_smoke.py``).
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import chunked_attention as CA

torch.set_num_threads(2)

SRC = (Path(CA.__file__).parent / "csrc" / "chunked_attention.cu").read_text()
SMEM_PER_BLOCK = 232448          # the most shared memory one block may use on sm_90


# ---------------------------------------------------------------------------
# The bf16 kernel's tiles, modelled
# ---------------------------------------------------------------------------

def row_bytes(hd):
    """Tile<HD>::kRowBytes: the widest swizzle atom that divides a row."""
    return 128 if (2 * hd) % 128 == 0 else 64 if (2 * hd) % 64 == 0 else 32


def warpgroups(hd):
    """WgmmaShape<HD>::kWG."""
    return 2 if hd > 128 else 1


def swizzle(off, W):
    return off ^ (((off >> 7) & (W // 16 - 1)) << 4)


def stored(hd, r, ch):
    """Tile<HD>::offset: byte offset of 16-byte chunk ``ch`` of row ``r``."""
    W = row_bytes(hd)
    byte = ch * 16
    return swizzle((byte // W) * 64 * W + r * W + byte % W, W)


def element(hd, r, d):
    """Where the loader put hd column ``d`` of tile row ``r``."""
    return stored(hd, r, d // 8) + 2 * (d % 8)


def k_major_read(hd, kk, m, k):
    """The byte wgmma reads for element (m, k) of k-step ``kk`` through
    Tile::k_major (start, SBO = 8 rows; K-major swizzled layout)."""
    W = row_bytes(hd)
    start = (kk * 32 // W) * 64 * W + (kk * 32) % W
    return swizzle(start + (m // 8) * 8 * W + (m % 8) * W + 2 * k, W)


def mn_major_read(hd, kk, col, n, k):
    """The byte wgmma reads for element (n, k) (n an hd column past
    ``col``, k a key of k-step ``kk``) through Tile::mn_major (start, LBO =
    one column block, SBO = 8 rows; MN-major swizzled layout)."""
    W = row_bytes(hd)
    start = (col * 2 // W) * 64 * W + kk * 16 * W
    lbo, sbo, atom = 64 * W, 8 * W, W // 2
    return swizzle(start + (n // atom) * lbo + (k // 8) * sbo + (k % 8) * W + 2 * (n % atom), W)


@pytest.mark.parametrize("hd", CA._HEAD_DIMS)
def test_tile_chunks_fill_the_tile_once(hd):
    """Every valid (row, chunk) maps to its own 16-byte slot, and the slots
    are exactly the tile's 64 * hd * 2 bytes: no pad chunk, no gap."""
    slots = [stored(hd, r, ch) for r in range(64) for ch in range(hd // 8)]
    assert all(s % 16 == 0 for s in slots)
    assert sorted(slots) == list(range(0, 64 * hd * 2, 16))
    W = row_bytes(hd)
    assert (2 * hd) % W == 0 and (64 * W) % 1024 == 0 and (64 * hd * 2) % 1024 == 0


@pytest.mark.parametrize("hd", CA._HEAD_DIMS)
def test_descriptor_reads_find_what_the_loader_stored(hd):
    # S = Q K^T: hd / 16 k-steps, each a 64 x 16 K-major operand
    for kk in range(hd // 16):
        for m in range(64):
            for k in range(16):
                assert k_major_read(hd, kk, m, k) == element(hd, m, 16 * kk + k)
    # O += P V: 4 k-steps of 16 keys; each warpgroup its hd / kWG columns
    n_cols = hd // warpgroups(hd)
    assert n_cols in (32, 64, 80, 96, 128)          # the P V widths wgmma_pv has
    for wg in range(warpgroups(hd)):
        col = wg * n_cols
        assert (2 * col) % row_bytes(hd) == 0        # a column block's first column
        for kk in range(4):
            for n in range(n_cols):
                for k in range(16):
                    assert mn_major_read(hd, kk, col, n, k) == element(hd, 16 * kk + k, col + n)


def test_model_matches_the_source():
    """The rules modelled above are the source's, and every head dim the
    wrappers take has a case in both kernels' switches and fits in shared
    memory: the bf16 kernel's five tiles + 1 KB, the f32 kernel's
    (2 (64 + 4) + 64) hd + 64 (64 + 4) floats."""
    assert ("kRowBytes = (2 * HD) % 128 == 0 ? 128 : (2 * HD) % 64 == 0 ? 64 : 32;" in SRC)
    assert "kWG = HD > 128 ? 2 : 1;" in SRC
    assert "return off ^ (((off >> 7) & kSwizzle) << 4);" in SRC
    assert "kSwizzle = kRowBytes / 16 - 1;" in SRC
    for macro in ("CHUNK_ATTN_F32", "CHUNK_ATTN_BF16"):
        cases = {int(d) for d in re.findall(rf"^\s*{macro}\((\d+)\)$", SRC, re.M)}
        assert cases == set(CA._HEAD_DIMS), macro
    for hd in CA._HEAD_DIMS:
        assert 5 * 64 * hd * 2 + 1024 <= SMEM_PER_BLOCK
        assert ((2 * 68 + 64) * hd + 64 * 68) * 4 <= SMEM_PER_BLOCK
    assert ((2 * 68 + 64) * 256 + 64 * 68) * 4 == 222208
