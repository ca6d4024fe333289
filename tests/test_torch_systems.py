"""The port's System layer against the JAX package: layout and accounting.

``shard_rows``/``row_validity_mask`` must place every row on the same
core at the same offset as the reference, and the same calls must leave
equal ``TransferStats`` under every reduce strategy.  Also here: the
port's import boundary (no JAX, nothing of ``repro``), its device rule
(``"cuda"`` without a GPU raises) and its command-line entry point.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.elastic import state as jstate
from repro.systems import base as jbase
from repro.systems import topology as jtopo

import repro_torch.api as tapi
from repro_torch.elastic import state as tstate
from repro_torch.systems import base as tbase
from repro_torch.systems import topology as ttopo

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def _pair(kind, **kw):
    return (japi.make_system(kind, **kw),
            tapi.make_system(kind, device="cpu", **kw))


@pytest.mark.parametrize("kind,n_cores", [("pim", 1), ("pim", 7),
                                          ("pim", 16), ("host", 8)])
@pytest.mark.parametrize("shape", [(1000, 13), (4096, 16), (1000,)])
def test_shard_layout_and_mask_match(kind, n_cores, shape):
    js, ts = _pair(kind, n_cores=n_cores)
    x = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
    a, b = js.shard_rows(x, pad_value=-1), ts.shard_rows(x, pad_value=-1)
    assert b.dtype == torch.int32 and b.is_contiguous()
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(ts.row_validity_mask(shape[0]).numpy(),
                                  np.asarray(js.row_validity_mask(shape[0])))
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)


def _jax_kernel(xc, yc, m, w, b):
    dot = xc @ w + b
    return {"g": xc.T @ (dot - yc) * 1, "n": jnp.sum(m), "c": jnp.sum(yc)}


def _torch_kernel(xc, yc, m, w, b):
    dot = torch.matmul(xc, w) + b
    return {"g": torch.matmul((dot - yc).unsqueeze(-2), xc).squeeze(-2),
            "n": torch.sum(m, -1, dtype=torch.int32),
            "c": torch.sum(yc, -1, dtype=torch.int32)}


@pytest.mark.parametrize("kind,n_cores", [("pim", 1), ("pim", 7),
                                          ("pim", 16), ("pim", 64),
                                          ("host", 8)])
@pytest.mark.parametrize("reduce", ["fabric", "host", "hierarchical",
                                    "hierarchical-auto"])
def test_transfer_stats_equal_after_the_same_calls(kind, n_cores, reduce):
    rng = np.random.RandomState(n_cores)
    X = rng.randint(-50, 50, (1000, 13)).astype(np.int32)
    y = rng.randint(-50, 50, 1000).astype(np.int32)
    w = rng.randint(-5, 5, 13).astype(np.int32)
    js, ts = _pair(kind, n_cores=n_cores, reduce=reduce)
    jx, jy = js.shard_rows(X), js.shard_rows(y)
    tx, ty = ts.shard_rows(X), ts.shard_rows(y)
    jm = js.row_validity_mask(1000).astype(jnp.int32)
    tm = ts.row_validity_mask(1000).to(torch.int32)
    jrep = js.broadcast((jnp.asarray(w), jnp.int32(3)))
    trep = ts.broadcast((torch.from_numpy(w),
                         torch.tensor(3, dtype=torch.int32)))
    for _ in range(2):
        jo = js.map_reduce(_jax_kernel, (jx, jy, jm), jrep)
        to = ts.map_reduce(_torch_kernel, (tx, ty, tm), trep)
        for k in ("g", "n", "c"):
            np.testing.assert_array_equal(np.asarray(to[k]),
                                          np.asarray(jo[k]))
    jc = js.map_reduce_custom(lambda a: {"lo": jnp.min(a), "hi": jnp.max(a)},
                              (jy,), (), {"lo": "min", "hi": "max"})
    tc = ts.map_reduce_custom(lambda a: {"lo": torch.amin(a, -1),
                                         "hi": torch.amax(a, -1)},
                              (ty,), (), {"lo": "min", "hi": "max"})
    assert int(tc["lo"]) == int(jc["lo"]) and int(tc["hi"]) == int(jc["hi"])
    je = js.map_elementwise(lambda a, s: a * s, (jy,), (jnp.int32(2),))
    te = ts.map_elementwise(lambda a, s: a * s, (ty,),
                            (torch.tensor(2, dtype=torch.int32),))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)


def test_dataset_views_cache_like_the_reference():
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (1000, 13)).astype(np.float32)
    y = rng.uniform(0, 1, 1000).astype(np.float32)
    js, ts = _pair("pim", n_cores=7)
    jd, td = js.put(X, y), ts.put(X, y)
    for ver in ("fp32", "int32", "hyb", "bui", "int32_lut_mram", "hyb_lut",
                "int32"):
        jv, tv = jd.gd_view(ver), td.gd_view(ver)
        for a, b in zip(jv, tv):
            assert str(b.dtype).split(".")[-1] == str(np.asarray(a).dtype)
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert td.n_views == jd.n_views == 3
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    with pytest.raises(ValueError):
        ts.put(X).gd_view("int32")


@pytest.mark.parametrize("n_cores", [1, 7, 16, 96, 100, 2048, 2556])
def test_topology_matches_the_reference(n_cores):
    assert ttopo.default_rank_size(n_cores) == jtopo.default_rank_size(
        n_cores)
    jt, tt = (jtopo.PimTopology.for_cores(n_cores),
              ttopo.PimTopology.for_cores(n_cores))
    for attr in ("dpus_per_rank", "n_ranks", "n_channels",
                 "cores_per_channel"):
        assert getattr(tt, attr) == getattr(jt, attr)
    start, size = n_cores // 3, max(1, n_cores // 2)
    assert dataclasses.astuple(tt.footprint(start, size)) == \
        dataclasses.astuple(jt.footprint(start, size))
    assert tt.mram_wram_cycles(5000) == jt.mram_wram_cycles(5000)


@pytest.mark.parametrize("args", [(10, 4, 0, 0), (10, 4, 3, 0), (17, 8, 5, 6),
                                  (5, 1, 0, 2), (3, 8, 0, 3)])
def test_chunk_schedule_and_ticks_match_the_reference(args):
    assert list(tbase.chunk_schedule(*args)) == \
        list(jbase.chunk_schedule(*args))
    tick = tbase.ChunkTick(3, lambda: {"meta": {"iters": 3}})
    assert tick == 3 and tick.resumable
    assert tick.snapshot()["meta"]["iters"] == 3
    assert tbase.ChunkTick(1).snapshot() is None

    def gen():
        yield 1
        return "done"
    assert tbase.run_steps(gen()) == jbase.run_steps(gen()) == "done"


def test_rng_pack_roundtrips_with_the_reference():
    rng = np.random.RandomState(11)
    rng.randint(0, 100, 37)
    ja, jm = jstate.pack_rng(rng)
    ta, tm = tstate.pack_rng(rng)
    np.testing.assert_array_equal(ta["rng_mt_keys"], ja["rng_mt_keys"])
    assert tm == jm
    a, b = tstate.unpack_rng(ja, jm), jstate.unpack_rng(ta, tm)
    assert a.randint(0, 1 << 30) == b.randint(0, 1 << 30)
    assert tstate.unpack_rng({}, {}) is None


def test_cuda_device_raises_without_a_gpu():
    """``device="cuda"`` never carries on on the CPU in its place."""
    if torch.cuda.is_available():
        assert tapi.make_system("pim", n_cores=4).device.type == "cuda"
        return
    for kind in ("pim", "host", "gpu-model"):
        with pytest.raises(RuntimeError, match="cuda"):
            tapi.make_system(kind, n_cores=4)
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.make_estimator("linreg", version="int32")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and (m == 'repro' or m.startswith('repro.') "
        "or m.split('.')[0] in ('jax', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules "
        "if m.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.pim_ml", *args],
        env=ENV, cwd=ROOT, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [
    ("--workload", "linreg", "--cores", "7", "--reduce", "hierarchical"),
    ("--workload", "logreg", "--system", "host",
     "--versions", "fp32,int32_lut_wram", "--sweep", "lr=2.0,5.0"),
    ("--workload", "kmeans", "--cores", "7", "--param", "n_init=2"),
    ("--workload", "kmeans", "--system", "host", "--versions", "fp32"),
])
def test_cli_runs_end_to_end_on_cpu(args):
    out = _cli("--device", "cpu", "--samples", "1000", "--features", "13",
               "--iters", "5", *args)
    assert out.returncode == 0, out.stderr
    assert "session:" in out.stdout
    assert ("transfers:" in out.stdout) or ("traffic:" in out.stdout)


def test_cli_runs_the_gpu_model_on_cpu():
    out = _cli("--device", "cpu", "--samples", "1000", "--features", "13",
               "--iters", "5", "--system", "gpu-model", "--versions",
               "fp32")
    assert out.returncode == 0, out.stderr
    assert "traffic:" in out.stdout
    assert "modeled A100:" in out.stdout and "over 5 launches" in out.stdout


def test_cli_grows_a_tree_on_cpu():
    out = _cli("--device", "cpu", "--samples", "1000", "--workload",
               "dtree", "--cores", "7", "--param", "max_depth=4")
    assert out.returncode == 0, out.stderr
    assert "fp32" in out.stdout and "transfers:" in out.stdout


@pytest.mark.parametrize("args,needle", [
    (("--workload", "dtree", "--fuse-steps", "4"), "step fusion"),
    (("--workload", "dtree", "--iters", "3"), "does not apply"),
])
def test_cli_refuses_what_is_not_ported(args, needle):
    out = _cli("--device", "cpu", "--samples", "100", *args)
    assert out.returncode != 0
    assert needle in out.stderr
