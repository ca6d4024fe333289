"""The PIM system over ``torch.distributed`` ranks against the JAX package.

``make_system("pim", backend="shard_map")`` spreads the cores over the
ranks of a gloo group (``spawn_ranks(..., device="cpu")``; the rank
bodies are ``tests/torch_ranks.py::pim_body``, which imports no JAX).
One group of 4 ranks and one of 2 run every case; the main process
holds each result against the reference's ``vmap`` backend on the same
numpy-seeded data, and against the port in one process:

* LIN (fp32, int32, hyb), LOG (int32, int32_lut_wram, int32_lut_mram),
  KME int16, DTR and EMB int32 (eager, D=8 deferred, D=8 compressed),
  each under fabric, host and hierarchical, on 16 cores over 4 ranks
  (hierarchical groups of 8 straddle ranks 0-1 and 2-3), 7 cores over 2
  ranks (4 + 3; ``hierarchical-auto`` makes one group of 7 across the
  boundary) and 1 core over 2 ranks (rank 1 owns none);
* integer versions bit-identical to the reference with equal
  ``TransferStats``; fp32 within ``FP32_RTOL``/``FP32_ATOL``
  (``tests/test_torch_train.py``'s) and the KME inertia, a float32 sum,
  within ``INERTIA_RTOL`` (``tests/test_torch_kmeans.py``'s);
* host and hierarchical bit-identical to the one-process port in every
  version, fp32 included; the model state equal on every rank after
  every step (digests of each step's state);
* fused LIN and KME fits (a chunk's steps run one by one over ranks);
* a ``PimSlice`` whose lease covers 2, 4, 3 and 0 cores of the ranks, a
  two-job manifest with ``backend: shard_map`` under the deadline policy
  (each job's lease on one rank), and snapshots resuming across world
  sizes;
* the reference's own ``backend="shard_map"`` on 8 forced host devices
  (a subprocess) against the port over 4 ranks.

The reference's ``mul_round_f32`` needs the ``enable_x64`` alias the
``x64_alias`` fixture sets for this file's tests.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest

import repro.api as japi
from repro.sched import manifest as jmanifest
from repro.sched.allocator import BankLease as JBankLease

import repro_torch.api as tapi
from repro_torch.data import synthetic as tsyn
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.sched import manifest as tmanifest
from repro_torch.systems import HierarchicalReduce, PimConfig, PimSystem
from repro_torch.systems.ranks import CoreBlocks, local_reduce

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

FP32_RTOL, FP32_ATOL = 1e-5, 1e-6
INERTIA_RTOL = 1e-6
#: a spawned group's limit (each took ~15 s here)
RANK_TIMEOUT = 240.0

DATA = {
    "lin": tsyn.make_linear_dataset(600, 6, seed=3)[:2],
    "log": tsyn.make_classification(600, 8, seed=4),
    "blobs": (tsyn.make_blobs(600, 4, centers=4, seed=5)[0], None),
    "cls": tsyn.make_classification(800, 6, n_informative=3,
                                    n_redundant=2, seed=5, class_sep=1.4),
    "recsys": tsyn.make_recsys(768, 45, 35, dim=4, seed=3),
}
EMB = {"n_iters": 16, "batch": 32, "dim": 4, "lr": 1.0, "frac_bits": 12,
       "seed": 1, "record_every": 4}
KME = {"n_clusters": 4, "max_iter": 6, "tol": 1e-4}
WORKLOADS = {
    "lin_fp32": ("linreg", "fp32", "lin", {"n_iters": 5}),
    "lin_int32": ("linreg", "int32", "lin", {"n_iters": 5}),
    "lin_hyb": ("linreg", "hyb", "lin", {"n_iters": 5}),
    "log_int32": ("logreg", "int32", "log", {"n_iters": 5}),
    "log_lut_wram": ("logreg", "int32_lut_wram", "log", {"n_iters": 5}),
    "log_lut_mram": ("logreg", "int32_lut_mram", "log", {"n_iters": 5}),
    "kme_int16": ("kmeans", "int16", "blobs", KME),
    "dtr": ("dtree", None, "cls", {"max_depth": 4}),
    "emb_eager": ("emb", "int32", "recsys", EMB),
    "emb_d8": ("emb", "int32", "recsys", {**EMB, "flush_every": 8}),
    "emb_d8c": ("emb", "int32", "recsys", {**EMB, "flush_every": 8,
                                          "compress_flush": True}),
    "lin_int32_fused": ("linreg", "int32", "lin",
                        {"n_iters": 7, "fuse_steps": 3}),
    "kme_fused": ("kmeans", "int16", "blobs", {**KME, "fuse_steps": 3}),
}
BASIC = [w for w in WORKLOADS if not w.endswith("_fused")]
#: world -> cores -> the reduces each workload runs under
LAYOUTS = {4: {16: ("fabric", "host", "hierarchical")},
           2: {7: ("fabric", "host", "hierarchical-auto"),
               1: ("fabric", "host", "hierarchical")}}
FUSED = [(4, 16, r, w) for w in ("lin_int32_fused", "kme_fused")
         for r in ("fabric", "hierarchical")]
FITS = [(world, cores, reduce, w) for world, layouts in LAYOUTS.items()
        for cores, reduces in layouts.items() for reduce in reduces
        for w in BASIC] + FUSED
#: the reference's own shard_map fits (8 forced devices): 8 cores
SHARD_MAP = ("lin_int32", "kme_int16")
SLICE_LEASE = (2, 9)              # ranks' shares: 2, 4, 3 and 0 cores
RESUME = ("lin_int32", "emb_d8")
RESUME_AT = 3
#: a 4-step chunk of a StepProgram over 7 cores
PROGRAM = {"kind": "program", "n_cores": 7, "k": 4}

MANIFEST = {
    "system": {"cores": 8, "rank_size": 4, "backend": "shard_map",
               "policy": "deadline"},
    "datasets": {
        "lin": {"kind": "linear", "samples": 256, "features": 8, "seed": 0},
        "blobs": {"kind": "blobs", "samples": 256, "features": 4,
                  "centers": 4, "seed": 1},
    },
    "jobs": [
        {"workload": "kmeans", "dataset": "blobs", "cores": 4,
         "deadline_seconds": 600, "params": {"n_clusters": 4,
                                             "max_iter": 5}},
        {"workload": "linreg", "dataset": "lin", "version": "int32",
         "cores": 4, "deadline_seconds": 300, "params": {"n_iters": 6}},
    ],
}


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


def _case(name: str, **extra) -> dict:
    workload, version, data, params = WORKLOADS[name]
    return {"kind": "fit", "workload": workload, "version": version,
            "data": data, "params": params, **extra}


def _fit_name(cores, reduce, w) -> str:
    return f"{w}/{cores}/{reduce}"


def _one_process(pkg, name: str, n_cores: int, reduce="fabric", state=None,
                 stop_after=None, system=None):
    """A fit of ``name`` in one process: the reference (``japi``) or the
    port on the CPU; its result model, or its snapshot at a step."""
    workload, version, data, params = WORKLOADS[name]
    kw = {} if pkg is japi else {"device": "cpu"}
    system = system or pkg.make_system("pim", n_cores=n_cores,
                                       reduce=reduce, **kw)
    X, y = DATA[data]
    wl = pkg.get_workload(workload)
    gen = wl.fit_steps(system.put(X, y), wl.spec(version, **params),
                       **({} if state is None else {"state": state}))
    steps = 0
    while True:
        try:
            tick = next(gen)
        except StopIteration as stop:
            return stop.value.model, system.stats
        steps += int(tick)
        if stop_after is not None and steps >= stop_after:
            snap = tick.snapshot()
            gen.close()
            return snap, system.stats


@pytest.fixture(scope="module")
def one_process_snapshots():
    """The one-process port's snapshots that the ranks resume from."""
    return {w: _one_process(tapi, w, 7, stop_after=RESUME_AT)[0]
            for w in RESUME}


@pytest.fixture(scope="module")
def ranks4():
    cases = {_fit_name(c, r, w): _case(w, n_cores=c, reduce=r)
             for world, c, r, w in FITS if world == 4}
    cases.update({_fit_name(8, "fabric", w): _case(w, n_cores=8,
                                                    reduce="fabric")
                  for w in SHARD_MAP})
    cases["slice"] = {
        "kind": "slice", "n_cores": 16, "lease": SLICE_LEASE,
        "fits": {w: _case(w) for w in ("lin_int32", "kme_int16")}}
    return spawn_ranks(torch_ranks.pim_body, 4, args=(DATA, cases),
                       device="cpu", timeout=RANK_TIMEOUT)


@pytest.fixture(scope="module")
def ranks2(one_process_snapshots):
    cases = {_fit_name(c, r, w): _case(w, n_cores=c, reduce=r)
             for world, c, r, w in FITS if world == 2}
    for w in RESUME:
        cases[f"stop/{w}"] = _case(w, n_cores=7, reduce="fabric",
                                   stop_after=RESUME_AT)
        cases[f"resume/{w}"] = _case(w, n_cores=7, reduce="fabric",
                                     state=one_process_snapshots[w])
    cases["manifest"] = {"kind": "manifest", "doc": MANIFEST}
    cases["program"] = PROGRAM
    return spawn_ranks(torch_ranks.pim_body, 2, args=(DATA, cases),
                       device="cpu", timeout=RANK_TIMEOUT)


def _ranks(request, world: int) -> list:
    return request.getfixturevalue(f"ranks{world}")


# ---------------------------------------------------------------------------
# Comparing results.
# ---------------------------------------------------------------------------

TREE_FIELDS = ("feature", "threshold", "left", "right", "leaf_class",
               "depth")


def _model_arrays(workload: str, m) -> dict:
    if workload in ("linreg", "logreg"):
        return {"w": m.w, "b": np.float32(m.b)}
    if workload == "kmeans":
        return {"centroids": m.centroids, "labels": m.labels,
                "n_iters": np.int64(m.n_iters)}
    if workload == "dtree":
        return {f: getattr(m, f) for f in TREE_FIELDS} | {
            "n_nodes": np.int64(m.n_nodes)}
    return {"user_raw": m.user_raw, "item_raw": m.item_raw,
            "history": np.asarray(m.history, np.float64),
            "n_flushes": np.int64(m.n_flushes)}


def _assert_same_model(got, want, workload: str, exact: bool,
                       inertia_exact=None):
    """Bit for bit where ``exact``; else to the fp32 tolerance.  A KME
    inertia, a float32 sum, is held to ``INERTIA_RTOL`` unless
    ``inertia_exact`` (default: ``exact``)."""
    ga, wa = _model_arrays(workload, got), _model_arrays(workload, want)
    assert sorted(ga) == sorted(wa)
    for k in wa:
        g, w = np.asarray(ga[k]), np.asarray(wa[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=FP32_RTOL,
                                       atol=FP32_ATOL, err_msg=k)
    if workload == "kmeans":
        if exact if inertia_exact is None else inertia_exact:
            assert got.inertia == want.inertia
        else:
            np.testing.assert_allclose(got.inertia, want.inertia,
                                       rtol=INERTIA_RTOL)


def _integer(name: str) -> bool:
    return WORKLOADS[name][1] != "fp32"


def _assert_ranks_agree(records: list):
    """Every rank ended with the same model and saw the same state after
    every step."""
    first = records[0]
    assert first["digests"], "no step ran"
    for rec in records[1:]:
        assert rec["digests"] == first["digests"]
        assert rec["stats"] == first["stats"]


# ---------------------------------------------------------------------------
# The fits.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,cores,reduce,name", FITS,
                         ids=[f"{c}over{w}-{r}-{n}" for w, c, r, n in FITS])
def test_fit_over_ranks_matches_reference(request, world, cores, reduce,
                                          name):
    records = [r[_fit_name(cores, reduce, name)]
               for r in _ranks(request, world)]
    _assert_ranks_agree(records)
    workload = WORKLOADS[name][0]
    for rec in records:
        _assert_same_model(rec["model"], records[0]["model"], workload,
                           exact=True)
    got = records[0]
    want, jstats = _one_process(japi, name, cores, reduce)
    _assert_same_model(got["model"], want, workload, exact=_integer(name),
                       inertia_exact=False)
    assert got["stats"] == dataclasses.asdict(jstats)
    # host and hierarchical sum as one process does, in every version
    port, _ = _one_process(tapi, name, cores, reduce)
    _assert_same_model(got["model"], port, workload,
                       exact=_integer(name) or reduce != "fabric",
                       inertia_exact=reduce != "fabric")
    blocks = [rec["block"] for rec in records]
    assert tuple(blocks) == CoreBlocks.even(cores, world, 0).bounds
    assert all(rec["traffic"]["calls"] > 0 for rec in records)


def test_a_fused_chunk_runs_its_steps_one_by_one_over_ranks(ranks2):
    """A chunk's k steps run eagerly with a reduce between them (the
    program counts an eager chunk, no graph), equal to one process's."""
    one = torch_ranks.pim_body(0, DATA, {"program": PROGRAM | {
        "backend": "vmap"}})["program"]
    for r in ranks2:
        rec = r["program"]
        assert rec["counts"] == {"eager": 1} == one["counts"]
        np.testing.assert_array_equal(rec["carry"], one["carry"])
        assert rec["stats"] == one["stats"]


def test_ranks_import_no_jax(ranks4, ranks2):
    assert not any(r["jax"] for r in ranks4 + ranks2)


def test_fabric_reduces_with_all_reduce_host_with_all_gather(ranks4):
    """What each strategy hands to the collectives: fabric sums its block
    then all-reduces; host gathers every core's partial."""
    fabric = ranks4[0][_fit_name(16, "fabric", "lin_int32")]["traffic"]
    host = ranks4[0][_fit_name(16, "host", "lin_int32")]["traffic"]
    assert fabric["all_reduce"] > 0 and "all_gather" not in fabric
    assert host["all_gather"] > 0 and "all_reduce" not in host


# ---------------------------------------------------------------------------
# The reference's own shard_map, on 8 forced host devices.
# ---------------------------------------------------------------------------

_SHARD_MAP_SCRIPT = r"""
import json, pickle, sys
import jax, jax.experimental
jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
import numpy as np
import repro.api as japi
spec = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, (workload, version, params, X, y) in spec.items():
    system = japi.make_system("pim", n_cores=8, backend="shard_map")
    wl = japi.get_workload(workload)
    res = wl.fit(system.put(X, y), wl.spec(version, **params))
    m = res.model
    if workload == "kmeans":
        out[name] = {"centroids": m.centroids, "labels": m.labels,
                     "n_iters": m.n_iters, "inertia": m.inertia}
    else:
        out[name] = {"w": m.w, "b": m.b}
    out[name]["stats"] = {k: int(v) for k, v in vars(system.stats).items()}
    out[name]["devices"] = len(jax.devices())
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def test_reference_shard_map_backend_equals_ranks(ranks4, tmp_path):
    import pickle
    spec = {}
    for name in SHARD_MAP:
        workload, version, data, params = WORKLOADS[name]
        spec[name] = (workload, version, params, *DATA[data])
    (tmp_path / "spec.pkl").write_bytes(pickle.dumps(spec))
    script = tmp_path / "shard_map.py"
    script.write_text(_SHARD_MAP_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run([sys.executable, str(script), str(tmp_path / "spec.pkl"),
                    str(tmp_path / "out.pkl")], env=env, check=True,
                   timeout=300)
    ref = pickle.loads((tmp_path / "out.pkl").read_bytes())
    for name in SHARD_MAP:
        got = ranks4[0][_fit_name(8, "fabric", name)]
        want = ref[name]
        assert want["devices"] == 8
        m = got["model"]
        if WORKLOADS[name][0] == "kmeans":
            np.testing.assert_array_equal(m.centroids, want["centroids"])
            np.testing.assert_array_equal(m.labels, want["labels"])
            assert m.n_iters == want["n_iters"]
            np.testing.assert_allclose(m.inertia, want["inertia"],
                                       rtol=INERTIA_RTOL)
        else:
            np.testing.assert_array_equal(m.w, want["w"])
            assert m.b == want["b"]
        assert got["stats"] == want["stats"]


# ---------------------------------------------------------------------------
# Slices, the manifest, resumes.
# ---------------------------------------------------------------------------

def test_slice_over_ranks_matches_reference(ranks4):
    """A lease of cores [2, 11) of 16 over 4 ranks: shares of 2, 4, 3 and
    0 cores; the slice's fits, its stats and its parent's equal the
    reference's vmap slice."""
    recs = [r["slice"] for r in ranks4]
    start, n = SLICE_LEASE
    assert [r["block"] for r in recs] == [(0, 2), (2, 6), (6, 9), (9, 9)]
    parent = japi.make_system("pim", n_cores=16)
    sl = parent.slice(JBankLease(start, n))
    for w in ("lin_int32", "kme_int16"):
        _assert_ranks_agree([rec["fits"][w] | {"stats": None}
                             for rec in recs])
        want, _ = _one_process(japi, w, n, system=sl)
        _assert_same_model(recs[0]["fits"][w]["model"], want,
                           WORKLOADS[w][0], exact=True, inertia_exact=False)
    for rec in recs:
        assert rec["stats"] == dataclasses.asdict(sl.stats)
        assert rec["parent_stats"] == dataclasses.asdict(parent.stats)


def test_manifest_over_ranks_matches_reference(ranks2):
    """Two jobs of 4 cores on 8 over 2 ranks under the deadline policy:
    each lease lies on one rank, the other rank's share is empty; the
    states, leases, stats and results equal the reference's (vmap)
    service."""
    doc = json.loads(json.dumps(MANIFEST))
    doc["system"]["backend"] = "vmap"
    _, handles = jmanifest.run_manifest(doc)
    want = [torch_ranks._job_sig(h) for h in handles]
    for rank, r in enumerate(ranks2):
        rec = r["manifest"]
        assert rec["backend"] == "shard_map"
        assert rec["block"] == [(0, 4), (4, 8)][rank]
        assert len(rec["jobs"]) == len(want) == 2
        for got, ref in zip(rec["jobs"], want):
            g = {k: v for k, v in got.items() if k != "model"}
            w = {k: v for k, v in ref.items() if k != "model"}
            assert g == w
            assert got["state"] == "done"
            _assert_same_model(got["model"], ref["model"], got["workload"],
                               exact=True, inertia_exact=False)
    leases = [j["lease"] for j in ranks2[0]["manifest"]["jobs"]]
    assert sorted(leases) == [(0, 4), (4, 4)]


@pytest.mark.parametrize("name", RESUME)
def test_snapshot_over_ranks_resumes_in_one_process(ranks2, name):
    snaps = [r[f"stop/{name}"]["snapshot"] for r in ranks2]
    for s in snaps[1:]:
        assert torch_ranks._state_digest(s["arrays"]) == \
            torch_ranks._state_digest(snaps[0]["arrays"])
    whole, _ = _one_process(tapi, name, 7)
    resumed, _ = _one_process(tapi, name, 5, state=snaps[0])
    workload = WORKLOADS[name][0]
    _assert_same_model(resumed, whole, workload, exact=True)
    ref, _ = _one_process(japi, name, 7)
    _assert_same_model(resumed, ref, workload, exact=True)


@pytest.mark.parametrize("name", RESUME)
def test_one_process_snapshot_resumes_over_ranks(ranks2, name):
    whole, _ = _one_process(tapi, name, 7)
    workload = WORKLOADS[name][0]
    for r in ranks2:
        _assert_same_model(r[f"resume/{name}"]["model"], whole, workload,
                           exact=True)


def test_pim_jobs_takes_its_group_from_torchruns_environment(tmp_path):
    """``pim_jobs`` on a ``backend: shard_map`` manifest initialises the
    default group from torchrun's variables (here one rank on a localhost
    port) and reports what the one-process service reports."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    doc = {k: v for k, v in MANIFEST.items() if k != "system"}
    doc["system"] = {"cores": 8, "rank_size": 4, "backend": "shard_map"}
    src = str(Path(__file__).resolve().parents[1] / "src")
    reports = {}
    for name, backend, env in (
            ("ranked", "shard_map", {"RANK": "0", "WORLD_SIZE": "1",
                                     "LOCAL_RANK": "0",
                                     "MASTER_ADDR": "127.0.0.1",
                                     "MASTER_PORT": str(port)}),
            ("one", "vmap", {})):
        doc["system"]["backend"] = backend
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(doc))
        run_env = {k: v for k, v in os.environ.items()
                   if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                "MASTER_ADDR", "MASTER_PORT")}
        run_env.update(env, PYTHONPATH=src + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.pim_jobs", str(path),
             "--device", "cpu", "--json", str(tmp_path / f"{name}.out.json")],
            env=run_env, timeout=120, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-3000:]
        reports[name] = json.loads((tmp_path / f"{name}.out.json")
                                   .read_text())
    keep = ("name", "state", "cores", "steps", "kernel_launches")
    rows = {name: [{k: row.get(k) for k in keep} for row in r["jobs"]]
            for name, r in reports.items()}
    assert rows["ranked"] == rows["one"]
    assert all(row["state"] == "done" for row in rows["ranked"])


# ---------------------------------------------------------------------------
# Without ranks.
# ---------------------------------------------------------------------------

def test_shard_map_without_a_group_raises():
    with pytest.raises(ValueError, match="process group"):
        tapi.make_system("pim", n_cores=4, device="cpu",
                         backend="shard_map")
    with pytest.raises(ValueError, match="process group"):
        tmanifest.build_system({"backend": "shard_map"}, device="cpu")
    with pytest.raises(ValueError, match="unknown PIM backend"):
        PimSystem(PimConfig(n_cores=4, device="cpu", backend="pmap"))
    est = tapi.make_estimator("linreg", system=tapi.make_system(
        "pim", n_cores=4, device="cpu"))
    est.set_params(n_cores=6)
    assert est.system.config.backend == "vmap" and est.n_cores == 6


@pytest.mark.parametrize("cores,world", [(16, 4), (7, 2), (1, 2), (5, 3),
                                         (2048, 2), (0, 3)])
def test_even_blocks(cores, world):
    blocks = [CoreBlocks.even(cores, world, r) for r in range(world)]
    sizes = blocks[0].sizes
    assert sum(sizes) == cores and max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)
    assert [(b.start, b.stop) for b in blocks] == list(blocks[0].bounds)
    assert all(b.n_cores == cores and b.world == world for b in blocks)


@pytest.mark.parametrize("start,stop", [(0, 16), (2, 11), (4, 8), (5, 6),
                                        (12, 16), (3, 3)])
def test_sub_blocks_are_each_ranks_share(start, stop):
    sub = CoreBlocks.even(16, 4, 1).sub(start, stop)
    assert sub.n_cores == stop - start
    owned = [c for c in range(start, stop) if 4 <= c < 8]
    assert (sub.start, sub.stop) == ((owned[0] - start, owned[-1] + 1
                                      - start) if owned else
                                     (sub.start, sub.start))
    assert sum(sub.sizes) == stop - start


@pytest.mark.parametrize("cores,world,group", [(16, 4, 8), (7, 2, 7),
                                               (16, 3, 4), (24, 5, 8),
                                               (8, 3, 8), (1, 2, 1)])
def test_hierarchical_plan_covers_every_core_once(cores, world, group):
    """Each rank's (head, whole groups, tail) covers its block; the raw
    pieces of the ranks complete every straddling group in order."""
    strat = HierarchicalReduce(group)
    blocks = CoreBlocks.even(cores, world, 0)
    covered, pending, n_groups = [], 0, 0
    for a, b in blocks.bounds:
        head, whole, tail = strat._plan(a, b)
        assert head + whole * group + tail == b - a
        covered += list(range(a, b))
        for raw, n in ((head, 0), (0, whole), (tail, 0)):
            if n:
                assert pending == 0
                n_groups += n
            pending += raw
            if pending == group:
                n_groups, pending = n_groups + 1, 0
            assert pending < group
    assert covered == list(range(cores)) and pending == 0
    assert n_groups == cores // group


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_an_empty_block_reduces_to_the_identity(op, dtype):
    import torch
    v = torch.zeros((0, 3, 2), dtype=getattr(torch, dtype))
    out = local_reduce(v, op)
    full = torch.tensor([[1, -2], [3, 4], [5, 6]],
                        dtype=getattr(torch, dtype))
    both = local_reduce(torch.stack([full, full]), op)
    # the identity leaves any partial unchanged
    combined = local_reduce(torch.stack([out, both]), op)
    assert out.shape == (3, 2) and torch.equal(combined, both)


def test_manifest_builds_the_ranked_system_spec():
    """``backend: shard_map`` is passed through to the PIM config (built
    inside a group only: outside one it raises, above)."""
    with pytest.raises(ValueError, match="only applies to kind: pim"):
        tmanifest.build_system({"kind": "host", "backend": "shard_map"},
                               device="cpu")
    system, _ = tmanifest.build_system({"backend": "vmap", "cores": 4},
                                       device="cpu")
    assert system.config.backend == "vmap" and system.ranks is None
