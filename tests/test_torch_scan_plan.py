"""The box scan's launch plan (``ops._scan_plan``), which is pure Python:
the shared memory it plans fits a block and equals the kernel's own
count in ``scan_topk.cu``, the grid is within CUDA's limits, and the row
tiles cover [0, N) exactly once. The plan depends on neither d nor m:
the kernel streams d in 16-wide slabs whatever its length and pads each
row's attrs to 8 floats."""

import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import ops

CU = (Path(ops.__file__).resolve().parent / "csrc" / "scan_topk.cu"
      ).read_text()


def _cu_smem_bytes(tr: int, k: int) -> int:
    """box_scan_smem_words(tr, k) * 4, evaluated from the CUDA source
    with its own constants."""
    consts = {}
    for name in ("MMAX", "BT", "BQ", "SD", "SLD", "PPT", "RP", "TD", "DLD"):
        expr = re.search(rf"constexpr int (?:[A-Z]+ = [^,;]+, )*{name} = "
                         rf"([^,;]+)[,;]", CU).group(1)
        consts[name] = eval(expr, {}, dict(consts))
    body = re.search(r"box_scan_smem_words\(int tr, int k\) \{\s*"
                     r"return ([^;]+);", CU, re.S).group(1)
    body = re.sub(r"\(RP > BQ \* DLD \? RP : BQ \* DLD\)",
                  "max(RP, BQ * DLD)", body).replace("/", "//")
    body = " ".join(body.split())
    return 4 * eval(body, {"max": max}, dict(consts, tr=tr, k=k))


@pytest.mark.parametrize("k", [1, 10, 40, 64])
@pytest.mark.parametrize("B", [1, 8, 32, 128, 256, 300])
def test_scan_plan_fits_and_covers(B, k):
    for N in (1, 63, 5000, 1_000_000):
        for sms in (1, 132):
            p = ops._scan_plan(B, N, k, sms)
            # the tallest tile whose shared memory fits a block
            assert p.tile_rows in ops.SCAN_TILE_ROWS
            assert p.smem == ops._scan_smem_bytes(p.tile_rows, k)
            assert p.smem == _cu_smem_bytes(p.tile_rows, k)
            assert p.smem <= ops.SMEM_LIMIT
            taller = [t for t in ops.SCAN_TILE_ROWS if t > p.tile_rows]
            assert all(ops._scan_smem_bytes(t, k) > ops.SMEM_LIMIT
                       for t in taller)
            # the kernel's box test splits a tile's 32-row words in two
            # halves, its dense path walks 32-row sub-tiles
            assert p.tile_rows % 64 == 0
            # grid (blocks, query blocks) of 512 threads: one block an SM
            # at most, every query in one query block
            assert 1 <= p.blocks <= min(sms, p.tiles) <= 2**31 - 1
            assert 1 <= p.query_blocks <= 65535
            assert (p.query_blocks - 1) * ops.SCAN_QUERY_BLOCK < B \
                <= p.query_blocks * ops.SCAN_QUERY_BLOCK
            # the tiles the blocks pull cover [0, N) exactly once
            starts = np.arange(p.tiles, dtype=np.int64) * p.tile_rows
            ends = np.minimum(starts + p.tile_rows, N)
            assert (ends > starts).all()
            assert starts[0] == 0 and ends[-1] == N
            assert (starts[1:] == ends[:-1]).all()


def test_scan_plan_tile_heights():
    # k = 40 (the quantized scan's over-fetch) keeps 256-row tiles; k = 64
    # needs 64-row ones
    assert ops._scan_plan(256, 10**6, 40, 132).tile_rows == 256
    assert ops._scan_plan(256, 10**6, 64, 132).tile_rows == 64
    assert ops._scan_plan(256, 10**6, 48, 132).tile_rows == 128
    with pytest.raises(ValueError, match="at most"):
        ops._scan_plan(65536 * 256, 10, 10, 132)
