"""The port's dry-run tools against the JAX package's, on the CPU.

* ``launch/analytic.py``: ``model_flops`` and ``memory_bytes`` equal the
  reference's, as floats, for every arch x shape (x 256 / 512 ranks);
* ``launch/roofline.py``: ``terms`` equals the reference's when handed
  the reference's TPU constants; the table keeps every status;
* ``launch/hlo_analysis.py``'s ``OpTrace``, in a subprocess that owns a
  fake process group: one matmul's flops exact, a loop of 8 counted 8
  times, a column-parallel linear's flops per rank halved on "model" = 2,
  a row-parallel one's all-reduce bytes equal to its output's; and what
  the dry-run takes from ``MemTracker`` (a private API): the peak of live
  storages;
* ``launch/dryrun.py``: the 80 cells' statuses (64 traced, 16 skipped),
  and the CLI in a subprocess on a fake (2, 2) mesh with the reduced
  configs: ``ok`` and ``skipped`` entries with the reference's keys
  (xlstm-350m's and hymba-1.5b's decode cells and every cell of
  llama-3.2-vision-11b and whisper-tiny but long_500k among the ``ok``),
  rendered by the roofline CLI.

The fake default group is process-global, so everything that makes one
runs in a subprocess of its own.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs.base import get_config as jget_config
from repro.configs.shapes import shape_for as jshape_for
from repro.launch import analytic as janalytic
from repro.launch import roofline as jroofline

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, shape_for
from repro_torch.launch import analytic, dryrun, roofline

ROOT = Path(__file__).resolve().parents[1]


def _run(code: str, *argv) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_equals_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in SHAPES:
        shape, jshape = shape_for(cfg, name), jshape_for(jcfg, name)
        assert analytic.model_flops(cfg, shape) == \
            janalytic.model_flops(jcfg, jshape)
        for chips in (256, 512):
            assert analytic.memory_bytes(cfg, shape, chips) == \
                janalytic.memory_bytes(jcfg, jshape, chips)


def _entry(flops=3e15, traffic=2e13, coll=5e11, model=4e17):
    return {"status": "ok", "n_devices": 256,
            "corrected": {"flops": flops, "traffic_bytes": traffic,
                          "collective_bytes": coll},
            "analytic": {"model_flops": model}}


@pytest.mark.parametrize("named", [True, False])
def test_terms_equal_the_reference_on_its_constants(named):
    cell = ("qwen3-8b", "train_4k") if named else ("", "")
    for entry in (_entry(), _entry(coll=5e13), _entry(traffic=9e15)):
        mine = roofline.terms(entry, 256, *cell, hw=roofline.TPU_V5E)
        assert mine == jroofline.terms(entry, 256, *cell)
    assert roofline.terms({"status": "skipped"}, 256) is None
    h = roofline.H100
    assert (h.peak_flops, h.hbm_bw, h.link_bw) == (989e12, 3.35e12, 450e9)
    t = roofline.terms(_entry(), 256)
    assert t["t_compute_s"] == 3e15 / 989e12


def test_table_keeps_every_status():
    results = {"qwen3-8b|train_4k|1pod": _entry(),
               "qwen3-8b|long_500k|1pod": {"status": "skipped",
                                           "reason": "quadratic"},
               "whisper-tiny|long_500k|1pod": {"status": "skipped",
                                               "reason": "quadratic"},
               "qwen3-8b|train_4k|2pod": {"status": "error"},
               "qwen3-8b|train_4k|1pod|mesh64x4": _entry()}
    rows = roofline.build_table(results, "1pod")
    assert [r["status"] for r in rows] == ["skipped", "ok", "skipped"]
    text = roofline.render_markdown(rows, "1pod")
    assert "| whisper-tiny | long_500k | — | — | — | skipped |" in text
    assert "h100-sxm" in text
    assert [r["status"] for r in roofline.build_table(results, "2pod")] \
        == ["error"]


def test_cell_statuses():
    counts = {"ok": 0, "skipped": 0}
    for arch in ARCH_IDS:
        for shape in SHAPES:
            entry = dryrun.cell_status(arch, shape)
            counts[entry["status"] if entry else "ok"] += 1
            if entry:
                assert shape == "long_500k", (arch, entry)
    # x 2 meshes: 64 ok, 16 skipped
    assert counts == {"ok": 32, "skipped": 8}


OPTRACE = r"""
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import Replicate
from repro_torch.distributed.sharding import place
from repro_torch.distributed.tp import matmul
from repro_torch.launch.dryrun import fake_world, peak_bytes
from repro_torch.launch.hlo_analysis import OpTrace
from repro_torch.launch.mesh import make_mesh
out = {}
with fake_world(2):
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")   # outside the mode
    with FakeTensorMode():
        x, w, w2 = torch.randn(64, 128), torch.randn(128, 256), torch.randn(256, 128)
        with OpTrace() as t:
            x @ w
        out["one"] = t.totals()["flops"]
        with OpTrace() as t:
            for _ in range(8):
                x @ w
        out["loop"] = t.totals()["flops"]
        xd = place(x, mesh, (None, None))
        wd = place(w, mesh, (None, "model"))
        w2d = place(w2, mesh, ("model", None))
        with OpTrace() as t:
            h = matmul(xd, wd)          # column-parallel
        out["col"] = t.totals()
        with OpTrace() as t:
            o = matmul(h, w2d).redistribute(      # row-parallel
                mesh, [Replicate(), Replicate()])
        out["row"] = t.totals()
        out["row_out_bytes"] = o.to_local().numel() * 4
tracker = MemTracker()       # real tensors: the peak of live storages
with tracker:
    a = torch.empty(1 << 18)       # 1 MiB
    b = torch.empty(1 << 19)       # 2 MiB
    del a
    c = torch.empty(1 << 17)       # 0.5 MiB
out["peak"] = peak_bytes(tracker)
print(json.dumps(out))
"""


def test_op_trace_counts_what_one_rank_runs():
    out = json.loads(_run(OPTRACE).strip().splitlines()[-1])
    assert out["one"] == 2 * 64 * 128 * 256
    assert out["loop"] == 8 * out["one"]
    assert out["col"]["flops"] == out["one"] / 2
    assert out["col"]["collective_bytes"] == 0
    assert out["row"]["collectives"] == {"all-reduce": out["row_out_bytes"]}
    assert out["row"]["collective_counts"] == {"all-reduce": 1}
    assert out["peak"] == 3 << 20


def test_dryrun_cli_on_a_small_fake_mesh(tmp_path):
    results = tmp_path / "results.json"
    # the recurrent archs at their decode cells: their train_4k and
    # prefill_32k cells loop over 4,096 and 32,768 sLSTM steps
    code = ("import sys; from repro_torch.launch import dryrun, roofline; "
            "run = lambda a, *x: dryrun.main(['--arch', a, '--device', "
            "'cpu', '--reduced', '--mesh-shape', '2,2', '--single-pod-only', "
            "'--results', sys.argv[1], *x]); "
            "[run(a) for a in ('qwen3-8b', 'llama-3.2-vision-11b', "
            "'whisper-tiny')]; "
            "[run(a, '--shape', s) for a in ('xlstm-350m', 'hymba-1.5b') "
            "for s in ('decode_32k', 'long_500k')]")
    _run(code, str(results))
    entries = json.loads(results.read_text())
    status = {k.split("|")[0] + "|" + k.split("|")[1]: e["status"]
              for k, e in entries.items()}
    assert status == {
        "qwen3-8b|train_4k": "ok", "qwen3-8b|prefill_32k": "ok",
        "qwen3-8b|decode_32k": "ok", "qwen3-8b|long_500k": "skipped",
        **{f"{a}|{s}": "ok" for a in ("llama-3.2-vision-11b",
                                       "whisper-tiny")
           for s in SHAPES if s != "long_500k"},
        "llama-3.2-vision-11b|long_500k": "skipped",
        "whisper-tiny|long_500k": "skipped",
        **{f"{a}|{s}": "ok" for a in ("xlstm-350m", "hymba-1.5b")
           for s in ("decode_32k", "long_500k")}}
    for cell in ("qwen3-8b|train_4k", "xlstm-350m|decode_32k",
                 "xlstm-350m|long_500k", "hymba-1.5b|decode_32k",
                 "hymba-1.5b|long_500k",
                 *(f"{a}|{s}" for a in ("llama-3.2-vision-11b",
                                        "whisper-tiny")
                   for s in SHAPES if s != "long_500k")):
        for key in ("mesh", "n_devices", "trace_s", "flops",
                    "bytes_accessed", "argument_bytes", "output_bytes",
                    "temp_bytes", "peak_bytes", "collectives", "corrected",
                    "analytic", "hlo_ops"):
            assert key in entries[f"{cell}|1pod|mesh2x2"], (cell, key)
    ok = entries["qwen3-8b|train_4k|1pod|mesh2x2"]
    assert ok["n_devices"] == 4 and ok["mesh"] == "data=2 x model=2"
    assert ok["corrected"]["flops"] > 0 and ok["peak_bytes"] > 0
    assert ok["corrected"]["collective_counts"]["all-reduce"] > 0
    # re-running skips every finished cell
    again = _run(code, str(results))
    assert "[cached]" in again and "[OK]" not in again
