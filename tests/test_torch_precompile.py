"""Port precompile CLI (``python -m repro_torch.tools.precompile``).

The case of ``tests/test_plan_cache.py::test_precompile_cli_smoke``: a
first run builds the plan (``cached=0``), a second finds it (``cached=1``).
The port's own cases: the CLI run as a subprocess writes plans that a fresh
``autochunk(..., cache=dir)`` of the same forward replays with zero search
passes, the plan kept the kernel target it was searched for, and lengths map
onto their bucket boundaries as in the JAX package's CLI.  Reduced gpt-paper
at 32 to 64 tokens.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import ChunkConfig, ChunkPlan, autochunk, stats
from repro_torch.models import model as M
from repro_torch.tools import precompile

torch.set_num_threads(2)
SRC = str(Path(__file__).resolve().parents[1] / "src")


def _rows(out: str):
    """The CSV rows of the CLI's output, headers left out."""
    return [line.split(",") for line in out.splitlines()
            if line and not line.startswith(("#", "config,"))]


def test_precompile_cli_cold_then_cached(tmp_path, capsys):
    argv = ["--configs", "gpt-paper", "--seq-lens", "40,60", "--budgets", "0.4",
            "--cache-dir", str(tmp_path / "plans"), "--kernel-target", "cpu"]
    assert precompile.main(argv) == 0
    out = capsys.readouterr()
    rows = _rows(out.out)
    assert [r[1] for r in rows] == ["64"]       # 40 and 60 share the 64 bucket
    assert rows[0][3] == "0" and rows[0][7] == "cpu"
    assert "[40, 60] -> [64]" in out.err
    (plan_file,) = (tmp_path / "plans").glob("*.json")
    assert ChunkPlan.load(plan_file).framework == "torch"
    assert precompile.main(argv) == 0
    assert _rows(capsys.readouterr().out)[0][3] == "1"


def test_precompile_subprocess_plans_hit_in_a_fresh_autochunk(tmp_path):
    plans = tmp_path / "plans"
    out = subprocess.run(
        [sys.executable, "-B", "-m", "repro_torch.tools.precompile", "--configs", "gpt-paper",
         "--seq-lens", "64", "--budgets", "0.3", "--exact-lens", "--cache-dir", str(plans)],
        cwd=tmp_path, capture_output=True, text=True, timeout=240,
        env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
             "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    (row,) = _rows(out.stdout)
    assert row[3] == "0" and int(row[4]) >= 1 and row[7] == "cpu"
    # the forward the CLI compiles: the reduced float32 config in list form
    cfg = get_config("gpt-paper").reduced().with_(dtype="float32", scan_layers=False)
    model = M.init_params(cfg, 0, device="cpu")
    params = dict(model.named_parameters())
    tokens = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 64)))
    batch = {"tokens": tokens}
    cf = autochunk(M.logits_fn(model), ChunkConfig(budget_ratio=0.3), cache=plans)
    before = stats.snapshot()
    compiled = cf.compile(params, batch)
    d = stats.delta(before)
    assert d["plan_cache_hits"] == 1 and d["plan_cache_misses"] == 0
    assert d["search_passes"] == d["selection_passes"] == 0
    assert compiled.from_cache and len(compiled.result.plan) == int(row[4])
    with torch.no_grad():
        want = M.logits_fn(model)(params, batch)
    np.testing.assert_allclose(compiled(params, batch).numpy(), want.numpy(), atol=1e-5)


def test_precompile_kernel_target_is_part_of_the_key(tmp_path, capsys):
    common = ["--configs", "gpt-paper", "--seq-lens", "32", "--budgets", "0.4",
              "--cache-dir", str(tmp_path / "plans")]
    assert precompile.main(common + ["--kernel-target", "cpu"]) == 0
    assert precompile.main(common + ["--kernel-target", "cuda"]) == 0
    rows = _rows(capsys.readouterr().out)
    assert [(r[3], r[7]) for r in rows] == [("0", "cpu"), ("0", "cuda")]
    assert len(list((tmp_path / "plans").glob("*.json"))) == 2
