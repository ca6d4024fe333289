"""The three-way compare (``launch/compare.py``) and the ``gpu-model``
target against the JAX package, on the CPU.

Both packages run ``run_compare(tiny=True, cores=4)`` on the same seeded
data.  The port's rows must be the reference's: the same 15 (workload,
system) rows and iteration counts, integer PIM scores bit-identical, DTR
scores equal, the fp32 host scores within the tolerances the port's fit
tests state (LIN/LOG ``FP32_RTOL``/``FP32_ATOL`` of
``tests/test_torch_train.py``, KME ``FP32_INERTIA_RTOL`` of
``tests/test_torch_kmeans.py``, EMB ``FP32_HIST_RTOL`` of
``tests/test_torch_emb.py``), and the PIM rows' modeled seconds and
transfer bytes equal.

The ``gpu-model`` target counts each launch's work with a
``TorchDispatchMode`` (``systems/gpu_model.py``) where the reference
reads XLA's cost analysis.  Its launches must equal the reference's.
Per launch, its flops stand within [1/4, 4] of XLA's; its bytes within
[1, 4] for LIN, LOG and KME, whose fp32 host fits reach no kernel op
(an unfused count cannot be below XLA's fused one), and within [1/4, 4]
for DTR, where the port charges ``gini_split``'s declared bytes.

EMB falls outside its band (flops ~0.03, bytes ~0.15 of XLA's), and the
op that differs is known: the reference's ``sparse_gather`` ops lower on
the host to a dense one-hot ``dot_general`` over every row of the table
(``repro/kernels/sparse_gather/ref.py``), 2 B R D + 2 B R flops a gather
and 2 R B D + 2 R B a scatter, with the one-hot operands' bytes, while
the port charges its kernels' declared cost: a selection of B rows (no
arithmetic) and one id compare per (row, lookup).  The EMB case checks
that the one-hot work is what XLA counts, and holds the port's count
with that work in place of its declared kernel costs to the band, so
every other op of the EMB launches is compared; ``PERF.md`` records the
raw ratios.
"""
import dataclasses
import json

import jax
import jax.experimental
import pytest

import repro.launch.compare as jcompare

import repro_torch.api as tapi
import repro_torch.launch.compare as tcompare
from repro_torch.kernels import dispatch

WORKLOADS = ("linreg", "logreg", "dtree", "kmeans", "emb")
INTEGER_PIM = {"linreg", "logreg", "kmeans", "emb"}
#: the fp32 host scores' tolerances (the fit tests' own, see above)
FP32_SCORE_TOL = {"linreg": (1e-5, 1e-6), "logreg": (1e-5, 1e-6),
                  "dtree": (0.0, 0.0), "kmeans": (1e-5, 0.0),
                  "emb": (1e-5, 0.0)}
#: flops and bytes bands of the port's per-launch count over XLA's
FLOPS_BAND = (0.25, 4.0)
BYTES_BAND = {"linreg": (1.0, 4.0), "logreg": (1.0, 4.0),
              "kmeans": (1.0, 4.0), "dtree": (0.25, 4.0),
              "emb": (0.25, 4.0)}
#: the port's modeled seconds within this of the reference's: at these
#: sizes the roofline's 5 us launch term dominates every launch
MODELED_S_RTOL = 0.10


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


def _recording(module, mp, **extra):
    """Run ``module.run_compare(tiny=True, cores=4, ...)``, keeping every
    system it makes; returns (record, {(workload, kind): system})."""
    made = []
    real = module.make_system

    def make_system(kind, **kw):
        system = real(kind, **kw)
        made.append(system)
        return system
    mp.setattr(module, "make_system", make_system)
    record = module.run_compare(tiny=True, cores=4, **extra)
    systems = {(row["workload"], row["system"]): s
               for row, s in zip(record["rows"], made)}
    return record, systems


@pytest.fixture(scope="module")
def both(x64_alias):
    with pytest.MonkeyPatch.context() as mp:
        ref = _recording(jcompare, mp)
        port = _recording(tcompare, mp, device="cpu")
    return ref, port


def _rows(record):
    return {(r["workload"], r["system"]): r for r in record["rows"]}


def test_compare_rows_are_the_references(both):
    (jrec, _), (trec, _) = both
    keys = [(r["workload"], r["system"]) for r in trec["rows"]]
    assert keys == [(r["workload"], r["system"]) for r in jrec["rows"]]
    assert len(keys) == 15
    assert trec["meta"] == {"tiny": True, "cores": 4, "seed": 0,
                            "systems": ["pim", "host", "gpu-model"],
                            "device": "cpu", "gpu": None}
    jr = _rows(jrec)
    for key, row in _rows(trec).items():
        for field in ("version", "samples", "features", "iterations",
                      "kernel_launches", "dram_bytes"):
            assert row[field] == jr[key][field], (key, field)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_compare_scores_are_the_references(both, workload):
    (jrec, _), (trec, _) = both
    jr, tr = _rows(jrec), _rows(trec)
    pim, jpim = tr[workload, "pim"], jr[workload, "pim"]
    if workload in INTEGER_PIM or workload == "dtree":
        assert pim["score"] == jpim["score"]
    host, jhost = tr[workload, "host"], jr[workload, "host"]
    rtol, atol = FP32_SCORE_TOL[workload]
    assert host["score"] == pytest.approx(jhost["score"], rel=rtol, abs=atol)
    # the gpu-model target runs the host target's numerics exactly
    assert tr[workload, "gpu-model"]["score"] == host["score"]
    assert jr[workload, "gpu-model"]["score"] == jhost["score"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_compare_pim_rows_model_what_the_reference_models(both, workload):
    (jrec, _), (trec, _) = both
    t, j = _rows(trec)[workload, "pim"], _rows(jrec)[workload, "pim"]
    for field in ("modeled_s", "modeled_kernel_s", "modeled_transfer_s",
                  "cpu_to_pim_bytes", "pim_to_cpu_bytes"):
        assert t[field] == j[field], field
    assert t["modeled_s"] > t["modeled_kernel_s"] > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_gpu_model_launches_equal_the_references(both, workload):
    (jrec, jsys), (trec, tsys) = both
    t, j = tsys[workload, "gpu-model"], jsys[workload, "gpu-model"]
    assert t.gpu.launches == j.gpu.launches > 0
    row = _rows(trec)[workload, "gpu-model"]
    assert row["modeled_launches"] == t.gpu.launches // 2   # warm + timed
    assert row["modeled_launches"] == _rows(jrec)[workload,
                                                  "gpu-model"]["kernel_launches"]
    jm = _rows(jrec)[workload, "gpu-model"]["modeled_s"]
    assert row["modeled_s"] == pytest.approx(jm, rel=MODELED_S_RTOL)
    assert row["modeled_energy_j"] == pytest.approx(
        row["modeled_s"] * t.roofline.tdp_w)


def _per_launch(system) -> tuple:
    g = system.gpu
    return g.flops / g.launches, g.hbm_bytes / g.launches


@pytest.mark.parametrize("workload", ["linreg", "logreg", "dtree", "kmeans"])
def test_gpu_model_counts_stand_in_bands_of_xlas(both, workload):
    (_, jsys), (_, tsys) = both
    (tf, tb), (jf, jb) = (_per_launch(tsys[workload, "gpu-model"]),
                          _per_launch(jsys[workload, "gpu-model"]))
    lo, hi = FLOPS_BAND
    assert lo <= tf / jf <= hi, (tf, jf)
    lo, hi = BYTES_BAND[workload]
    assert lo <= tb / jb <= hi, (tb, jb)


def _program(system, kind: str) -> tuple:
    """(flops, bytes, operand signature) of the one program of ``kind``
    ("map_reduce": EMB's forward, "elem": its apply) in a gpu-model
    system's cost cache (the port's forward is one callable a fit, so it
    may stand there twice, with one cost)."""
    found = {(v, k[1]) for k, v in system._cost_cache.items()
             if k[0][0] == kind}
    assert len({v for v, _ in found}) == 1, found
    (flops, nbytes), sig = found.pop()
    return flops, nbytes, sig


def _one_hot(kind: str, b: int, r: int, d: int) -> tuple:
    """(flops, bytes) XLA counts for the reference's one-hot lowering of
    one float32 ``sparse_gather`` op: the (B, R) one-hot (a compare and a
    convert an element, written), its dot with the (R, D) rows or the
    (B, D) updates, and for a scatter the add into the table."""
    if kind == "gather":
        return (2 * b * r + 2 * b * r * d,
                4 * (b + r + b * r) + 4 * (b * r + r * d + b * d))
    return (2 * r * b + 2 * r * b * d + r * d,
            4 * (r + b + r * b) + 4 * (r * b + b * d + r * d)
            + 4 * 3 * r * d)


def _declared(kind: str, b: int, r: int, d: int) -> tuple:
    """The port's declared cost of one such op on one shard (C = 1)."""
    if kind == "gather":
        return 0, 4 * (b * d + b * d + b)
    return r * b, 4 * (2 * r * d + r + b + b * d)


@pytest.mark.parametrize("program,op", [("map_reduce", "gather"),
                                        ("elem", "scatter")])
def test_gpu_model_emb_counts_differ_from_xlas_by_the_one_hot_lowering(
        both, program, op):
    (_, jsys), (_, tsys) = both
    tf, tb, sig = _program(tsys["emb", "gpu-model"], program)
    jf, jb, _ = _program(jsys["emb", "gpu-model"], program)
    # the operands: tables (1, R, D) at 0 and 2, the lookups (B,) after
    # the forward's five shards or the apply's four
    (_, ru, d), (_, ri, _) = sig[0][0], sig[2][0]
    b = sig[5 if program == "map_reduce" else 4][0][0]
    one_hot = [_one_hot(op, b, r, d) for r in (ru, ri)]
    declared = [_declared(op, b, r, d) for r in (ru, ri)]
    # the raw count falls outside the band: the kernels do not do a
    # dense product over every row
    assert tf / jf < FLOPS_BAND[0] and tb / jb < BYTES_BAND["emb"][0]
    # the one-hot lowering is nearly all of XLA's count ...
    oh_f, oh_b = (sum(v[i] for v in one_hot) for i in (0, 1))
    assert 0.98 <= oh_f / jf <= 1.0 and 0.98 <= oh_b / jb <= 1.0
    # ... and with the same work in place of the declared kernel costs,
    # the port's count of the rest of the launch stands in the band
    dec_f, dec_b = (sum(v[i] for v in declared) for i in (0, 1))
    lo, hi = FLOPS_BAND
    assert lo <= (tf - dec_f + oh_f) / jf <= hi
    lo, hi = BYTES_BAND["emb"]
    assert lo <= (tb - dec_b + oh_b) / jb <= hi


def test_gpu_model_count_floor_for_lin_fp32(both):
    """One LIN fp32 step reads X twice (the forward and the gradient
    matvecs): at least 4 n f flops and 2 n f 4 bytes, whatever fusion
    does."""
    (_, _), (trec, tsys) = both
    row = _rows(trec)["linreg", "gpu-model"]
    n, f = row["samples"], row["features"]
    flops, nbytes = _per_launch(tsys["linreg", "gpu-model"])
    assert flops >= 4 * n * f
    assert nbytes >= 2 * n * f * 4


@pytest.mark.parametrize("workload,version,fuse", [
    ("linreg", "fp32", 5), ("logreg", "fp32", 10), ("kmeans", "fp32", 4)])
def test_gpu_model_prices_a_fused_chunk_as_one_launch(workload, version,
                                                      fuse):
    n, f, params = tcompare._shapes(True)[workload]
    X, y = tcompare._make_data(workload, n, f, 0)
    wl = tapi.get_workload(workload)
    fits = {}
    for k in (1, fuse):
        system = tapi.make_system("gpu-model", n_cores=4, device="cpu")
        host = tapi.make_system("host", n_cores=4, device="cpu")
        spec = wl.spec(version, **params, fuse_steps=k)
        res = wl.fit(system.put(X, y), spec)
        ref = wl.fit(host.put(X, y), spec)
        assert wl.score(res, X, y) == wl.score(ref, X, y)
        assert system.gpu.launches == system.stats.kernel_launches
        fits[k] = system
    serial, fused = fits[1], fits[fuse]
    assert fused.gpu.launches < serial.gpu.launches
    if workload != "kmeans":       # KME's end-of-fit launches stay serial
        assert fused.gpu.launches == -(-params["n_iters"] // fuse)
    # k steps' work in one launch: fewer launch overheads, the same order
    # of work
    assert fused.gpu.modeled_seconds < serial.gpu.modeled_seconds
    assert 0.5 <= fused.gpu.flops / serial.gpu.flops <= 2.0


def test_gpu_model_is_the_host_target_on_the_callers_device():
    system = tapi.make_system("gpu_model", n_cores=3, device="cpu")
    assert isinstance(system, tapi.ModeledGpuSystem)
    assert isinstance(system, tapi.HostSystem)
    assert system.kind == "gpu-model" and system.device.type == "cpu"
    assert system.roofline.name == "a100-sxm4-40g"
    assert dataclasses.asdict(system.gpu) == dict(
        modeled_seconds=0.0, modeled_energy_j=0.0, launches=0, flops=0.0,
        hbm_bytes=0.0)
    snap = system.gpu.snapshot()
    X, y = tcompare._make_data("linreg", 200, 4, 0)
    tapi.make_estimator("linreg", version="fp32", n_iters=3,
                        system=system).fit(X, y)
    d = system.gpu.delta(snap)
    assert d.launches == 3 and d.flops > 0 and d.hbm_bytes > 0
    assert dispatch.meters == []


def test_compare_main_writes_the_record(tmp_path, capsys):
    out = tmp_path / "compare.json"
    tcompare.main(["--tiny", "--cores", "4", "--device", "cpu", "--out",
                   str(out)])
    printed = capsys.readouterr().out
    assert printed.startswith("compare on cpu, 4 cores")
    assert "modeled A100" in printed.splitlines()[0]
    record = json.loads(out.read_text())
    assert record["meta"]["device"] == "cpu"
    assert len(record["rows"]) == 15
    meta = record["run_meta"]
    assert meta["gpu"] is None and meta["torch_version"]
    assert {"git_sha", "git_dirty", "timestamp", "python",
            "platform"} <= set(meta)
    assert all(r["modeled_s"] > 0 for r in record["rows"])


def _print_counts() -> None:
    """The ratios PERF.md records: per launch, the port's count over
    XLA's for each workload's gpu-model fits, the modeled seconds' ratio,
    and for EMB's two programs the one-hot share of XLA's count and the
    ratio with the declared kernel costs exchanged for it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        (jrec, jsys), (trec, tsys) = (_recording(jcompare, mp),
                                      _recording(tcompare, mp, device="cpu"))
    for w in WORKLOADS:
        (tf, tb), (jf, jb) = (_per_launch(tsys[w, "gpu-model"]),
                              _per_launch(jsys[w, "gpu-model"]))
        tm, jm = (_rows(rec)[w, "gpu-model"]["modeled_s"]
                  for rec in (trec, jrec))
        print(f"{w}: {tsys[w, 'gpu-model'].gpu.launches // 2} launches; "
              f"flops/launch {tf:.6g} (XLA {jf:.6g}, ratio {tf / jf:.4f}); "
              f"bytes/launch {tb:.6g} (XLA {jb:.6g}, ratio {tb / jb:.4f}); "
              f"modeled_s ratio {tm / jm:.4f}")
    for program, op in (("map_reduce", "gather"), ("elem", "scatter")):
        tf, tb, sig = _program(tsys["emb", "gpu-model"], program)
        jf, jb, _ = _program(jsys["emb", "gpu-model"], program)
        (_, ru, d), (_, ri, _) = sig[0][0], sig[2][0]
        b = sig[5 if program == "map_reduce" else 4][0][0]
        oh = [_one_hot(op, b, r, d) for r in (ru, ri)]
        de = [_declared(op, b, r, d) for r in (ru, ri)]
        ohf, ohb, df, db = (sum(v[i] for v in vs)
                            for vs, i in ((oh, 0), (oh, 1), (de, 0), (de, 1)))
        print(f"emb {program}: port {tf:.6g} flops / {tb:.6g} B, XLA "
              f"{jf:.6g} / {jb:.6g}; one-hot share of XLA's "
              f"{ohf / jf:.4f} / {ohb / jb:.4f}; exchanged ratio "
              f"{(tf - df + ohf) / jf:.4f} / {(tb - db + ohb) / jb:.4f}")


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_compare.py
    _print_counts()
