"""The port's elastic base against the JAX package: checkpoints on disk,
job snapshots, fingerprints, fault injection, the migration rule and the
straggler monitor.

A checkpoint written by either package must load in the other with equal
arrays, manifest and envelope, and a fit resumed from a snapshot taken in
either package must be bit-identical to the uninterrupted fit, in both
packages, for LIN int32 (full batch, fused, and minibatch SGD with its
MT19937 stream), LOG int32_lut_wram and KME int16.
"""
import json
import os

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.elastic as jel
from repro.data import synthetic as jsyn
from repro.train import checkpoint as jckpt
from repro.train import fault_tolerance as jft

import repro_torch.api as tapi
import repro_torch.elastic as tel
from repro_torch.obs import TRACER
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import fault_tolerance as tft


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    """The reference's ``mul_round_f32`` calls the removed
    ``jax.experimental.enable_x64``; alias it for this file only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


def _tree(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(5).astype(np.float32),
            "b": np.float32(rng.randn()),
            "nested": {"ids": rng.randint(0, 9, (3, 2)).astype(np.int32),
                       "mask": rng.rand(4) < 0.5,
                       "keys": rng.randint(0, 2 ** 31, 624)
                       .astype(np.uint32)},
            "seq": [np.arange(3, dtype=np.int64),
                    rng.randn(2, 2).astype(np.float64)]}


def _same_arrays(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        x = a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]
        y = b[k].numpy() if isinstance(b[k], torch.Tensor) else b[k]
        assert np.asarray(x).dtype == np.asarray(y).dtype, k
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# train/checkpoint.py: one on-disk format for both packages.
# ---------------------------------------------------------------------------

_VOLATILE = ("time",)


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("seed", [0, 1])
def test_checkpoint_written_by_either_loads_in_both(tmp_path, writer, seed):
    d = str(tmp_path / "ck")
    tree = _tree(seed)
    (tckpt if writer == "port" else jckpt).save(
        d, 7, tree, keep_last=2, extra_meta={"note": "x", "n": 3})
    assert sorted(os.listdir(d)) == ["step_00000007"]
    assert sorted(os.listdir(os.path.join(d, "step_00000007"))) == [
        "arrays.npz", "manifest.json"]
    ta, tm = tckpt.restore_raw(d, 7)
    ja, jm = jckpt.restore_raw(d, 7)
    _same_arrays(ta, ja)
    assert {k: v for k, v in tm.items() if k not in _VOLATILE} == \
        {k: v for k, v in jm.items() if k not in _VOLATILE}
    assert tm["note"] == "x" and tm["step"] == 7
    assert sorted(ta) == ["b", "nested/ids", "nested/keys", "nested/mask",
                          "seq/[0]", "seq/[1]", "w"]


def test_checkpoint_manifests_of_the_same_tree_are_equal(tmp_path):
    tree = _tree(3)
    tckpt.save(str(tmp_path / "t"), 2, tree)
    jckpt.save(str(tmp_path / "j"), 2, tree)
    _, tm = tckpt.restore_raw(str(tmp_path / "t"), 2)
    _, jm = jckpt.restore_raw(str(tmp_path / "j"), 2)
    for k in ("exotic_dtypes", "step", "n_arrays", "total_bytes",
              "keys_checksum"):
        assert tm[k] == jm[k], k


def test_checkpoint_of_tensors_and_bf16(tmp_path):
    d = str(tmp_path / "ck")
    w = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    tree = {"w": w, "h": w.to(torch.bfloat16), "i": torch.arange(5)}
    tckpt.save(d, 1, tree)
    arrays, manifest = tckpt.restore_raw(d, 1)
    assert manifest["exotic_dtypes"] == {"h": "bfloat16"}
    assert torch.equal(arrays["h"], tree["h"])
    np.testing.assert_array_equal(arrays["w"], w.numpy())
    ja, _ = jckpt.restore_raw(d, 1)       # ml_dtypes bfloat16 there
    np.testing.assert_array_equal(np.asarray(ja["h"], np.float32),
                                  tree["h"].float().numpy())
    back = tckpt.restore(d, 1, {"w": torch.zeros(3, 4),
                                "h": torch.zeros(3, 4, dtype=torch.bfloat16),
                                "i": np.zeros(5)})
    assert torch.equal(back["w"], w) and torch.equal(back["h"], tree["h"])
    np.testing.assert_array_equal(back["i"], np.arange(5))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(d, 1, {"w": torch.zeros(4, 3), "h": torch.zeros(3, 4),
                             "i": np.zeros(5)})
    with pytest.raises(ValueError, match="arrays"):
        tckpt.restore(d, 1, {"w": torch.zeros(3, 4)})


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_prune_keeps_the_previously_latest_for_one_save(tmp_path, pkg):
    ck = tckpt if pkg == "port" else jckpt
    d = str(tmp_path / "ck")

    def steps():
        return sorted(int(x.split("_")[1]) for x in os.listdir(d)
                      if x.startswith("step_"))
    ck.save(d, 1, {"w": np.ones(3)}, keep_last=1)
    ck.save(d, 2, {"w": np.ones(3) * 2}, keep_last=1)
    assert ck.latest_step(d) == 2 and steps() == [1, 2]
    ck.save(d, 3, {"w": np.ones(3) * 3}, keep_last=1)
    assert steps() == [2, 3]
    assert tckpt.latest_step(d) == jckpt.latest_step(d) == 3
    assert tckpt.latest_step(str(tmp_path / "none")) is None


def test_async_checkpointer_writes_off_thread(tmp_path):
    d = str(tmp_path / "ck")
    ac = tckpt.AsyncCheckpointer(d, keep_last=2)
    w = torch.zeros(4)
    for step in range(1, 4):
        w += 1
        ac.save(step, {"w": w})       # copied before the next += lands
    ac.wait()
    assert tckpt.latest_step(d) == 3
    for step in (2, 3):
        np.testing.assert_array_equal(tckpt.restore_raw(d, step)[0]["w"],
                                      np.full(4, float(step), np.float32))


# ---------------------------------------------------------------------------
# Fingerprints, fault injection, migration, schema.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(4))
def test_fingerprints_equal_the_reference(case):
    rng = np.random.RandomState(case)
    X = rng.randn(20, 3).astype(np.float32 if case % 2 else np.float64)
    y = None if case == 2 else rng.randn(20).astype(np.float32)
    params = {"n_iters": 5 + case, "lr": np.float32(0.25), "seed": 3,
              "minibatch": np.int64(case)}
    for fn, args in ((lambda m: m.dataset_fingerprint, (X, y)),
                     (lambda m: m.spec_fingerprint,
                      ("linreg", "int32", params)),
                     (lambda m: m.job_fingerprint,
                      ("kmeans", "int16", params, X, y))):
        assert fn(tel)(*args) == fn(jel)(*args)
    a, b = tel.job_fingerprint("linreg", "int32", params, X, y).split("-")
    assert len(a) == len(b) == 32


@pytest.mark.parametrize("text", ["job0*:3", "*:2:5", "lin*:1,kme*:4",
                                  " a:1 , ,b:2:0", ""])
def test_fault_injector_parses_and_fires_as_the_reference(text):
    port, ref = tel.FaultInjector.parse(text), jel.FaultInjector.parse(text)
    assert [vars(p) for p in port.plans] == [vars(p) for p in ref.plans]
    turns = [(name, step) for step in range(1, 6)
             for name in ("job0", "lin1", "kme2", "a", "b")] * 2
    assert [port(*t) for t in turns] == [ref(*t) for t in turns]
    assert port.fired == ref.fired


@pytest.mark.parametrize("text", ["nostep", "a:b", "a:1:2:3"])
def test_fault_injector_rejects_what_the_reference_rejects(text):
    for mod in (tel, jel):
        with pytest.raises(ValueError):
            mod.FaultInjector.parse(text)


def test_fault_injector_from_env():
    env = {tel.ENV_VAR: "job*:2"}
    assert tel.ENV_VAR == jel.ENV_VAR == "REPRO_INJECT_FAULT"
    inj = tel.injector_from_env(env)
    assert inj("job1", 2) and not inj("job1", 2)
    assert tel.injector_from_env({}) is None
    assert issubclass(tel.InjectedFault, RuntimeError)
    inj = tel.FaultInjector()
    inj.plan("x", 1, count=2)
    assert inj("x", 1) and inj("x", 1) and not inj("x", 1)


KINDS = ("pim", "host", "gpu-model", "other")
VERSIONS = ("fp32", "int32", "int16", "hyb")


def test_migration_matrix_equals_the_reference():
    for a in KINDS:
        for b in KINDS:
            for v in VERSIONS:
                ok = tel.migration_ok(a, b, v)
                assert ok == jel.migration_ok(a, b, v), (a, b, v)
                if ok:
                    tel.check_migration(a, b, v)
                else:
                    with pytest.raises(ValueError, match="fixed-point"):
                        tel.check_migration(a, b, v)
    assert not tel.migration_ok("pim", "host", "int32")
    assert tel.migration_ok("host", "gpu-model", "int32")


def test_schema_and_snapshot_iters():
    assert tel.SCHEMA_VERSION == jel.SCHEMA_VERSION
    for state in (None, {}, {"meta": {}}, {"meta": {"iters": 7}}):
        assert tel.snapshot_iters(state) == jel.snapshot_iters(state)
    assert sorted(tel.__all__) == sorted(jel.__all__)
    for key in ("job 0/linreg:int32", "a.b-c_d", "üx"):
        assert tel.job_dir("/r", key) == jel.job_dir("/r", key)


# ---------------------------------------------------------------------------
# Job snapshots across packages, and resumed fits.
# ---------------------------------------------------------------------------

_ENVELOPE = {"workload": "linreg", "version": "int32", "params": {"lr": 0.1},
             "fingerprint": "f-g", "system_kind": "pim", "iters": 4,
             "steps": 4, "accounting": {"kernel_launches": 4}}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshot_envelope_roundtrips_across_packages(tmp_path, writer):
    snap = {"arrays": {"w": np.arange(4, dtype=np.float32),
                       "rng_mt_keys": np.arange(624, dtype=np.uint32)},
            "meta": {"iters": 4, "history": [[2, 0.5]], "rng_pos": 3}}
    d = tel.job_dir(str(tmp_path), "job0")
    (tel if writer == "port" else jel).save_snapshot(d, snap,
                                                     envelope=_ENVELOPE)
    assert tel.has_checkpoint(d) and jel.has_checkpoint(d)
    (ts, te), (js, je) = tel.load_snapshot(d), jel.load_snapshot(d)
    _same_arrays(ts["arrays"], js["arrays"])
    _same_arrays(ts["arrays"], snap["arrays"])
    assert ts["meta"] == js["meta"] == snap["meta"]
    assert te == je == {"elastic_schema": 1, **_ENVELOPE}


def test_load_snapshot_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):
        tel.load_snapshot(str(tmp_path / "none"))
    d = str(tmp_path / "plain")
    tckpt.save(d, 1, {"w": np.ones(2)})       # no elastic envelope
    with pytest.raises(ValueError, match="schema"):
        tel.load_snapshot(d)


def test_save_snapshot_is_traced(tmp_path):
    TRACER.clear()
    TRACER.enable()
    try:
        tel.save_snapshot(str(tmp_path / "j"), {"arrays": {}, "meta": {}},
                          envelope={"iters": 3})
        events = TRACER.events()
    finally:
        TRACER.disable()
        TRACER.clear()
    assert [(e["ph"], e["name"], e["track"], e["cat"], e["args"])
            for e in events] == [("X", "ckpt.save", "sched", "elastic",
                                  {"iters": 3})]


RESUME_CASES = {
    "lin_int32": ("linreg", "int32", dict(n_iters=12)),
    "lin_int32_fused": ("linreg", "int32", dict(n_iters=12, fuse_steps=3)),
    "lin_int32_sgd": ("linreg", "int32", dict(n_iters=12, minibatch=16,
                                              seed=5)),
    "log_int32_lut_wram": ("logreg", "int32_lut_wram", dict(n_iters=12)),
    "kme_int16": ("kmeans", "int16", dict(n_clusters=4, max_iter=10,
                                          n_init=2, seed=1, tol=0.0)),
}


def _data(workload):
    if workload == "kmeans":
        X, _, _ = jsyn.make_blobs(300, 5, centers=4, seed=2)
        return X, None
    X, y, _ = jsyn.make_linear_dataset(300, 6, seed=2)
    if workload == "logreg":
        y = (y > np.median(y)).astype(np.float32)
    return X, y


def _system(api):
    if api is tapi:
        return api.make_system("pim", n_cores=7, device="cpu")
    return api.make_system("pim", n_cores=7)


def _drain(gen):
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


def _model(result, workload):
    attrs = (("cluster_centers_", "labels_") if workload == "kmeans"
             else ("coef_", "intercept_"))
    return [np.asarray(result.attributes[a]) for a in attrs]


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_from_either_package_is_bit_identical(tmp_path, writer, case):
    """Snapshot after 3 chunks in the writer's package, saved through its
    ``save_snapshot``; loaded and resumed in the other package (and in
    the writer's): every resumed fit equals the uninterrupted fits of
    both packages bit for bit."""
    workload, version, params = RESUME_CASES[case]
    X, y = _data(workload)
    src, dst = ((tapi, japi) if writer == "port" else (japi, tapi))
    src_el = tel if writer == "port" else jel
    wl = src.get_workload(workload)
    system = _system(src)
    gen = wl.fit_steps(system.put(X, y), wl.spec(version, **params))
    for _ in range(3):
        tick = next(gen)
    snap = tick.snapshot()
    d = src_el.job_dir(str(tmp_path), case)
    src_el.save_snapshot(d, snap, envelope={"iters": snap["meta"]["iters"]})

    want = {}
    for api in (tapi, japi):
        w = api.get_workload(workload)
        s = _system(api)
        want[api] = _model(w.fit(s.put(X, y), w.spec(version, **params)),
                           workload)
    for api, el in ((dst, tel if dst is tapi else jel),
                    (src, src_el)):
        state, _ = el.load_snapshot(d)
        w = api.get_workload(workload)
        s = _system(api)
        got = _model(_drain(w.fit_steps(s.put(X, y),
                                        w.spec(version, **params),
                                        state=state)), workload)
        for g, a, b in zip(got, want[tapi], want[japi]):
            np.testing.assert_array_equal(g, a)
            np.testing.assert_array_equal(g, b)


# ---------------------------------------------------------------------------
# The straggler monitor.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("series", [
    [1.0] * 20,
    [1.0, 1.1, 0.9, 1.0, 1.05, 5.0, 1.0, 1.0, 9.0, 1.02, 0.98],
    list(np.random.RandomState(0).lognormal(0.0, 0.3, 60)),
    [0.0] * 7 + [1e-3],
])
def test_straggler_monitor_flags_as_the_reference(series):
    port, ref = tft.StragglerMonitor(), jft.StragglerMonitor()
    assert [port.observe(float(s)) for s in series] == \
        [ref.observe(float(s)) for s in series]
    assert (port.flagged, port.n, port.mean, port.var) == \
        (ref.flagged, ref.n, ref.mean, ref.var)
    json.dumps(vars(port))
