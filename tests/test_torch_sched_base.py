"""The scheduler's base in the port against the JAX package: the bank
allocator, the slices of every target, and the fused learning-rate gang.

Everything runs on the CPU.  The same allocate/release sequences must
give the same leases, rejections and ``FragmentationStats`` in both
packages.  Slices must scope shards and mirror stats as the reference's
do, and a fit on a slice must be bit-identical to the same fit on a
standalone system of the lease's width.  A ``FusedGdSweep`` lane must be
bit-identical, for every integer version, to the reference's gang lane
and to the port's own serial fit at the lane's learning rate, with equal
``TransferStats``; fp32 lanes are held to ``FP32_RTOL``/``FP32_ATOL``,
the tolerance of the serial fp32 parity tests in
``tests/test_torch_train.py`` (the lane product is a matrix product, the
serial one a matrix-vector product: float32 sums in another order).

The reference's ``mul_round_f32`` calls ``jax.experimental.enable_x64``,
which this JAX no longer has; :func:`x64_alias` aliases it for this
file's tests only.
"""
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.sched as jsched
from repro.core import fixed_point as jfx
from repro.data import synthetic as jsyn

import repro_torch.api as tapi
import repro_torch.sched as tsched
from repro_torch.core import linreg as tlin
from repro_torch.kernels import dispatch
from repro_torch.kernels.quant_matmul import fx_matvec_plain
from repro_torch.systems.base import TransferStats

FP32_RTOL, FP32_ATOL = 1e-5, 1e-6
ITERS = 6
LRS = {"linreg": (0.02, 0.1, 0.3), "logreg": (1.0, 2.0, 4.0)}
GANG_CASES = [("linreg", v) for v in ("int32", "hyb", "fp32")] + [
    ("logreg", v) for v in ("int32_lut_wram", "int32_lut_mram", "hyb_lut")]


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


@pytest.fixture(scope="module")
def data():
    X, y, _ = jsyn.make_linear_dataset(600, 9, seed=4)
    return X, y, (y > np.median(y)).astype(np.float32)


def _targets(data, workload):
    X, y, yc = data
    return X, (y if workload == "linreg" else yc)


def _stats(stats) -> dict:
    return {f.name: getattr(stats, f.name)
            for f in dataclasses.fields(TransferStats)}


def _same_weights(got_w, got_b, want_w, want_b, version):
    if version == "fp32":
        np.testing.assert_allclose(got_w, want_w, rtol=FP32_RTOL,
                                   atol=FP32_ATOL)
        np.testing.assert_allclose(got_b, want_b, rtol=FP32_RTOL,
                                   atol=FP32_ATOL)
    else:
        np.testing.assert_array_equal(got_w, want_w)
        assert got_b == want_b


# ---------------------------------------------------------------------------
# BankAllocator: the same sequences give the same leases in both packages.
# ---------------------------------------------------------------------------

def _lease(lease) -> tuple:
    return (lease.start, lease.n_cores, tuple(lease.ranks),
            tuple(lease.channels))


def _drive(pkg, n_cores, rank_size, placement, seed):
    """A seeded allocate/release sequence; every outcome recorded."""
    alloc = pkg.BankAllocator(n_cores, rank_size=rank_size,
                              placement=placement)
    rng = np.random.RandomState(seed)
    live, log = [], []
    for _ in range(40):
        if live and rng.rand() < 0.4:
            lease = live.pop(rng.randint(len(live)))
            alloc.release(lease)
            log.append(("release", _lease(lease)))
        else:
            want = int(rng.randint(1, max(2, n_cores // 3)))
            lease = alloc.allocate(want)
            log.append(("allocate", want,
                        None if lease is None else _lease(lease)))
            if lease is not None:
                live.append(lease)
        log.append(dataclasses.asdict(alloc.fragmentation()))
    return log, alloc.rank_size


@pytest.mark.parametrize("n_cores,rank_size", [
    (64, 16), (96, None), (100, None), (2048, 64), (7, None), (48, 8)])
@pytest.mark.parametrize("placement", ["first_fit", "contention"])
@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_sequences_match_reference(n_cores, rank_size, placement,
                                             seed):
    port = _drive(tsched, n_cores, rank_size, placement, seed)
    ref = _drive(jsched, n_cores, rank_size, placement, seed)
    assert port == ref


@pytest.mark.parametrize("n", [1, 7, 64, 96, 100, 128, 2048, 2560])
def test_default_rank_size_matches_reference(n):
    assert tsched.default_rank_size(n) == jsched.default_rank_size(n)
    assert tsched.BankAllocator(n).rank_size == jsched.BankAllocator(
        n).rank_size


@pytest.mark.parametrize("bad", [
    lambda p: p.BankAllocator(16, rank_size=4).allocate(17),
    lambda p: p.BankAllocator(16, rank_size=4).allocate(0),
    lambda p: p.BankAllocator(16, rank_size=4).release(p.BankLease(0, 4)),
    lambda p: p.BankAllocator(16, rank_size=5),
    lambda p: p.BankAllocator(0),
    lambda p: p.BankAllocator(16, placement="best_fit"),
])
def test_allocator_rejects_what_the_reference_rejects(bad):
    for pkg in (jsched, tsched):
        with pytest.raises(ValueError):
            bad(pkg)


def test_allocator_release_coalesces_to_one_extent():
    alloc = tsched.BankAllocator(32, rank_size=8)
    leases = [alloc.allocate(8) for _ in range(4)]
    alloc.release(leases[2])
    alloc.release(leases[1])
    frag = alloc.fragmentation()
    assert (frag.free_cores, frag.n_free_extents,
            frag.largest_free_extent) == (16, 1, 16)
    assert frag.external_fragmentation == 0.0
    alloc.release(leases[0])
    alloc.release(leases[3])
    assert alloc.fragmentation().n_free_extents == 1
    assert alloc.free_cores == 32


# ---------------------------------------------------------------------------
# Slices.
# ---------------------------------------------------------------------------

def test_pim_slice_scopes_shards_and_mirrors_stats():
    parent = tapi.make_system("pim", n_cores=16, device="cpu")
    sl = parent.slice(tsched.BankLease(4, 4))
    assert isinstance(sl, tsched.PimSlice) and sl.config.n_cores == 4
    xs = sl.shard_rows(np.arange(12, dtype=np.float32))
    assert tuple(xs.shape) == (4, 3)
    nbytes = xs.numel() * xs.element_size()
    assert sl.stats.cpu_to_pim == parent.stats.cpu_to_pim == nbytes
    sl.stats.reset()                       # slice-local only
    assert sl.stats.cpu_to_pim == 0
    assert parent.stats.cpu_to_pim == nbytes
    snap = sl.stats.snapshot()
    assert type(snap) is TransferStats


def test_slice_shares_kernels_not_graphs():
    parent = tapi.make_system("pim", n_cores=16, device="cpu")
    a = parent.slice(tsched.BankLease(0, 8))
    b = parent.slice(tsched.BankLease(8, 8))
    assert a._kernels is parent._kernels is b._kernels
    assert a._kernel_gen is parent._kernel_gen
    assert a._step_cache is not b._step_cache
    assert a._step_cache is not parent._step_cache


@pytest.mark.parametrize("kind", ["pim", "host", "gpu-model"])
def test_slice_lease_must_fit_parent(kind):
    parent = tapi.make_system(kind, n_cores=8, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        parent.slice(tsched.BankLease(4, 8))


@pytest.mark.parametrize("n_cores,lease", [(16, (4, 4)), (16, (8, 8)),
                                           (12, (6, 6))])
def test_pim_slice_shards_match_reference(data, n_cores, lease):
    X, y = _targets(data, "linreg")
    js = japi.PimSystem(japi.PimConfig(n_cores=n_cores))
    jsl = jsched.PimSlice(js, jsched.BankLease(*lease))
    ts = tapi.make_system("pim", n_cores=n_cores, device="cpu")
    tsl = ts.slice(tsched.BankLease(*lease))
    jv = jsl.put(X, y).gd_view("int32")
    tv = tsl.put(X, y).gd_view("int32")
    for j, t in zip(jv, tv):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert _stats(tsl.stats) == _stats(jsl.stats)
    assert _stats(ts.stats) == _stats(js.stats)


def test_disjoint_slices_bit_identical_to_standalone(data):
    """LIN int32 and LOG int32_lut_wram on two slices of one machine, and
    KME int16 on a third: each equals the same fit on a standalone system
    of its lease's width, the reference's slice fits too, and the
    parent's counters are the sum of the slices' deltas."""
    X, y, yc = data
    Xb, _, _ = jsyn.make_blobs(600, 4, centers=4, seed=1)
    parent = tapi.make_system("pim", n_cores=16, device="cpu")
    alloc = tsched.BankAllocator(16, rank_size=4)
    jparent = japi.PimSystem(japi.PimConfig(n_cores=16))
    jalloc = jsched.BankAllocator(16, rank_size=4)
    fits = [("linreg", "int32", (X, y), 4), ("logreg", "int32_lut_wram",
                                            (X, yc), 8),
            ("kmeans", "int16", (Xb, None), 4)]
    before = parent.stats.snapshot()
    deltas = []
    for workload, version, (Xw, yw), cores in fits:
        params = (dict(n_clusters=4, max_iter=5, tol=0.0)
                  if workload == "kmeans" else dict(n_iters=ITERS))
        sl = parent.slice(alloc.allocate(cores))
        jsl = jparent.slice(jalloc.allocate(cores))
        alone = tapi.make_system("pim", n_cores=cores, device="cpu")
        snap = sl.stats.snapshot()
        got = tapi.make_estimator(workload, version=version, system=sl,
                                  **params).fit(sl.put(Xw, yw))
        deltas.append(sl.stats.delta(snap))
        want = tapi.make_estimator(workload, version=version, system=alone,
                                   **params).fit(alone.put(Xw, yw))
        ref = japi.make_estimator(workload, version=version, system=jsl,
                                  **params).fit(jsl.put(Xw, yw))
        attrs = (("cluster_centers_", "labels_") if workload == "kmeans"
                 else ("coef_", "intercept_"))
        for a in attrs:
            np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
            np.testing.assert_array_equal(getattr(got, a), getattr(ref, a))
        assert _stats(sl.stats) == _stats(alone.stats) == _stats(jsl.stats)
    total = parent.stats.delta(before)
    for f in dataclasses.fields(TransferStats):
        assert getattr(total, f.name) == sum(getattr(d, f.name)
                                             for d in deltas), f.name
    assert alloc.fragmentation().n_leases == 3


@pytest.mark.parametrize("kind", ["host", "gpu-model"])
def test_lane_slices_deltas_sum_to_parent(data, kind):
    X, y = _targets(data, "linreg")
    parent = tapi.make_system(kind, n_cores=8, device="cpu")
    jparent = japi.make_system(kind, n_cores=8)
    deltas, gpu = [], []
    for i, (workload, version) in enumerate((("linreg", "fp32"),
                                             ("logreg", "fp32"))):
        lease = tsched.BankLease(4 * i, 4)
        sl = parent.slice(lease)
        jsl = jparent.slice(jsched.BankLease(4 * i, 4))
        assert type(sl).__name__ == type(jsl).__name__
        snap = sl.stats.snapshot()
        gsnap = sl.gpu.snapshot() if kind == "gpu-model" else None
        Xw, yw = _targets(data, workload)
        tapi.make_estimator(workload, version=version, n_iters=ITERS,
                            system=sl).fit(sl.put(Xw, yw))
        japi.make_estimator(workload, version=version, n_iters=ITERS,
                            system=jsl).fit(jsl.put(Xw, yw))
        deltas.append(sl.stats.delta(snap))
        assert _stats(sl.stats) == _stats(jsl.stats)
        if gsnap is not None:
            gpu.append(sl.gpu.delta(gsnap))
            assert sl._cost_cache is parent._cost_cache
    for f in dataclasses.fields(TransferStats):
        assert getattr(parent.stats, f.name) == sum(
            getattr(d, f.name) for d in deltas), f.name
    assert _stats(parent.stats) == _stats(jparent.stats)
    if kind == "gpu-model":
        assert parent.gpu.launches == sum(g.launches for g in gpu) > 0
        assert parent.gpu.modeled_seconds == pytest.approx(
            sum(g.modeled_seconds for g in gpu))
        assert parent.gpu.launches == jparent.gpu.launches


# ---------------------------------------------------------------------------
# Fusion planning.
# ---------------------------------------------------------------------------

def _plan_specs(pkg_api):
    lin, log, kme = (pkg_api.get_workload(n)
                     for n in ("linreg", "logreg", "kmeans"))
    return lin, log, kme, [
        lin.spec("int32", lr=0.1, n_iters=50),
        lin.spec("int32", lr=0.5, n_iters=50),
        lin.spec("hyb", lr=0.1, n_iters=50),
        lin.spec("int32", lr=0.1, n_iters=50, minibatch=8),
        lin.spec("int32", lr=0.2, n_iters=50, seed=3),
        lin.spec("int32", lr=0.1, n_iters=40),
        lin.spec("int32", lr=0.1, n_iters=50, record_every=5),
        lin.spec("int32", lr=0.7, n_iters=50, fuse_steps=4)]


def _without_backend(key):
    """A reference fuse key without the reference's ``kernel_backend``
    parameter (the port picks the kernel by the tensor's device and has
    no such parameter)."""
    if key is None:
        return None
    name, version, shared = key
    return name, version, tuple(kv for kv in shared
                                if kv[0] != "kernel_backend")


def test_fuse_key_and_plan_fusion_match_reference():
    t_lin, t_log, t_kme, t_specs = _plan_specs(tapi)
    j_lin, j_log, j_kme, j_specs = _plan_specs(japi)
    assert [tsched.fuse_key(t_lin, s) for s in t_specs] == \
        [_without_backend(jsched.fuse_key(j_lin, s)) for s in j_specs]
    assert tsched.plan_fusion(t_lin, t_specs) == \
        jsched.plan_fusion(j_lin, j_specs) == [[0, 1, 4], [2], [3], [5],
                                               [6], [7]]
    assert tsched.fuse_key(t_kme, t_kme.spec()) is None
    assert tsched.fuse_key(t_log, t_log.spec("int32_lut_wram")) == \
        _without_backend(jsched.fuse_key(j_log,
                                         j_log.spec("int32_lut_wram")))
    assert set(tsched.FUSABLE_WORKLOADS) == set(jsched.FUSABLE_WORKLOADS)
    with pytest.raises(ValueError, match="not fusable"):
        tsched.FusedGdSweep(t_lin, t_specs[:3], None)


# ---------------------------------------------------------------------------
# The fused gang.
# ---------------------------------------------------------------------------

def _gang(pkg_api, pkg_sched, system, workload, version, data, lrs,
          cancel_after=None, **params):
    X, yw = _targets(data, workload)
    ds = system.put(X, yw)
    wl = pkg_api.get_workload(workload)
    specs = [wl.spec(version, lr=lr, n_iters=ITERS, **params) for lr in lrs]
    snap = system.stats.snapshot()
    gang = pkg_sched.FusedGdSweep(wl, specs, ds)
    steps = 0
    while not gang.done:
        gang.step()
        steps += 1
        if cancel_after is not None and gang.it == cancel_after:
            gang.deactivate(1)
    return gang, system.stats.delta(snap), steps


def _serial(workload, version, data, lr, n_cores, iters=ITERS, **params):
    X, yw = _targets(data, workload)
    system = tapi.make_system("pim", n_cores=n_cores, device="cpu")
    return tapi.make_estimator(workload, version=version, lr=lr,
                               n_iters=iters, system=system,
                               **params).fit(system.put(X, yw))


@pytest.mark.parametrize("workload,version", GANG_CASES)
@pytest.mark.parametrize("n_cores", [4, 7])
def test_gang_matches_reference_gang_and_serial_fits(data, workload, version,
                                                     n_cores):
    lrs = LRS[workload]
    ts = tapi.make_system("pim", n_cores=n_cores, device="cpu")
    js = japi.make_system("pim", n_cores=n_cores)
    gang, delta, steps = _gang(tapi, tsched, ts, workload, version, data,
                               lrs)
    jgang, jdelta, _ = _gang(japi, jsched, js, workload, version, data, lrs)
    assert steps == ITERS and delta.kernel_launches == ITERS
    assert _stats(delta) == _stats(jdelta)
    for lane, lr in enumerate(lrs):
        got = gang.result(lane)
        ref = jgang.result(lane)
        serial = _serial(workload, version, data, lr, n_cores)
        assert got.model.w.dtype == np.float32 and got.model.n_iters == ITERS
        _same_weights(got.model.w, got.model.b, ref.model.w, ref.model.b,
                      version)
        _same_weights(got.model.w, got.model.b, serial.coef_,
                      serial.intercept_, version)
        assert got.attributes["coef_"] is got.model.w


@pytest.mark.parametrize("workload,version", [("linreg", "int32"),
                                              ("logreg", "int32_lut_wram"),
                                              ("linreg", "hyb")])
def test_gang_in_chunks_matches_reference_and_unchunked(data, workload,
                                                        version):
    """``fuse_steps=8`` over 20 iterations: chunks of 8, 8 and 4, one
    launch and one sync each; every lane equal to the unchunked gang, to
    the reference's chunked gang and to the serial fit."""
    lrs = LRS[workload]
    iters = 20
    ts = tapi.make_system("pim", n_cores=7, device="cpu")
    js = japi.make_system("pim", n_cores=7)
    X, yw = _targets(data, workload)
    results = {}
    for name, pkg_api, pkg_sched, system, fuse in (
            ("chunked", tapi, tsched, ts, 8), ("eager", tapi, tsched, ts, 1),
            ("ref", japi, jsched, js, 8)):
        wl = pkg_api.get_workload(workload)
        ds = system.put(X, yw)
        gang = pkg_sched.FusedGdSweep(
            wl, [wl.spec(version, lr=lr, n_iters=iters, fuse_steps=fuse)
                 for lr in lrs], ds)
        snap = system.stats.snapshot()
        steps = 0
        while not gang.step():
            steps += 1
        delta = system.stats.delta(snap)
        results[name] = (gang, delta, steps + 1)
    gang, delta, steps = results["chunked"]
    assert steps == 3 and delta.kernel_launches == delta.host_syncs == 3
    assert _stats(delta) == _stats(results["ref"][1])
    for lane, lr in enumerate(lrs):
        serial = _serial(workload, version, data, lr, 7, iters=iters)
        for other in ("eager", "ref"):
            o = results[other][0].result(lane).model
            _same_weights(gang.result(lane).model.w,
                          gang.result(lane).model.b, o.w, o.b, version)
        _same_weights(gang.result(lane).model.w, gang.result(lane).model.b,
                      serial.coef_, serial.intercept_, version)
    assert not ts._step_cache       # the last chunk released the graphs


@pytest.mark.parametrize("fuse", [1, 2])
@pytest.mark.parametrize("workload,version", [("linreg", "int32"),
                                              ("logreg", "int32_lut_wram")])
def test_gang_lane_cancel_freezes_the_lane(data, workload, version, fuse):
    """Lane 1 cancelled after iteration 2 (between chunks when fused):
    it reports no result and its weights stop moving; the survivors stay
    equal to serial fits and to the reference's gang."""
    lrs = LRS[workload]
    ts = tapi.make_system("pim", n_cores=4, device="cpu")
    js = japi.make_system("pim", n_cores=4)
    gang, delta, _ = _gang(tapi, tsched, ts, workload, version, data, lrs,
                           cancel_after=2, fuse_steps=fuse)
    jgang, jdelta, _ = _gang(japi, jsched, js, workload, version, data, lrs,
                             cancel_after=2, fuse_steps=fuse)
    assert gang.result(1) is None and jgang.result(1) is None
    assert delta.kernel_launches == (ITERS if fuse == 1 else ITERS // 2)
    assert _stats(delta) == _stats(jdelta)
    frozen = _serial(workload, version, data, lrs[1], 4, iters=2)
    np.testing.assert_array_equal(gang.lane_state(1)["arrays"]["w"],
                                  frozen.coef_)
    for lane in (0, 2):
        serial = _serial(workload, version, data, lrs[lane], 4)
        for other in (serial.coef_, jgang.result(lane).model.w):
            np.testing.assert_array_equal(gang.result(lane).model.w, other)


def test_gang_stops_when_every_lane_is_cancelled(data):
    ts = tapi.make_system("pim", n_cores=4, device="cpu")
    X, y = _targets(data, "linreg")
    wl = tapi.get_workload("linreg")
    gang = tsched.FusedGdSweep(
        wl, [wl.spec("int32", lr=lr, n_iters=ITERS) for lr in (0.1, 0.2)],
        ts.put(X, y))
    gang.step()
    gang.deactivate(0)
    gang.deactivate(1)
    assert gang.done and gang.step() and gang.it == 1


@pytest.mark.parametrize("direction", ["port", "reference"])
@pytest.mark.parametrize("workload,version", [("linreg", "int32"),
                                              ("logreg", "int32_lut_wram")])
def test_lane_state_resumes_as_a_serial_fit(data, workload, version,
                                            direction):
    """A lane's snapshot after 3 gang steps resumes as an ordinary fit
    (in the port, or in the reference) equal to the uninterrupted serial
    fit."""
    lr = LRS[workload][2]
    ts = tapi.make_system("pim", n_cores=7, device="cpu")
    X, yw = _targets(data, workload)
    wl = tapi.get_workload(workload)
    gang = tsched.FusedGdSweep(
        wl, [wl.spec(version, lr=x, n_iters=ITERS)
             for x in LRS[workload]], ts.put(X, yw))
    for _ in range(3):
        gang.step()
    state = gang.lane_state(2)
    assert state["meta"] == {"iters": 3, "history": []}
    api = tapi if direction == "port" else japi
    kwargs = {"device": "cpu"} if direction == "port" else {}
    system = api.make_system("pim", n_cores=7, **kwargs)
    rwl = api.get_workload(workload)
    gen = rwl.fit_steps(system.put(X, yw),
                        rwl.spec(version, lr=lr, n_iters=ITERS), state=state)
    steps = 0
    while True:
        try:
            next(gen)
            steps += 1
        except StopIteration as stop:
            resumed = stop.value
            break
    assert steps == ITERS - 3
    serial = _serial(workload, version, data, lr, 7)
    np.testing.assert_array_equal(np.asarray(resumed.attributes["coef_"]),
                                  serial.coef_)
    assert float(resumed.attributes["intercept_"]) == serial.intercept_


@pytest.mark.parametrize("fuse", [1, 4])
def test_zero_iteration_gang_charges_nothing(data, fuse):
    ts = tapi.make_system("pim", n_cores=8, device="cpu")
    X, y = _targets(data, "linreg")
    ds = ts.put(X, y)
    wl = tapi.get_workload("linreg")
    snap = ts.stats.snapshot()
    gang = tsched.FusedGdSweep(
        wl, [wl.spec("int32", lr=lr, n_iters=0, fuse_steps=fuse)
             for lr in (0.1, 0.2)], ds)
    dispatch.reset_launch_counts()
    assert gang.done and gang.step()
    delta = ts.stats.delta(snap)
    assert delta.kernel_launches == delta.cpu_to_pim - delta.shard_bytes \
        == 0
    assert not dispatch.launch_counts
    assert gang.result(0).model.n_iters == 0
    np.testing.assert_array_equal(gang.result(1).model.w, np.zeros(9))


def test_gang_prices_every_lane_on_the_gpu_model(data):
    """On the ``gpu-model`` target a gang launch is charged the declared
    cost of its lane-batched ``fx_matvec``: four int32 operations an
    element of x for each lane."""
    X, y = _targets(data, "linreg")
    counts = {}
    for k in (1, 3):
        system = tapi.make_system("gpu-model", n_cores=4, device="cpu")
        wl = tapi.get_workload("linreg")
        gang = tsched.FusedGdSweep(
            wl, [wl.spec("int32", lr=0.1 * (i + 1), n_iters=1)
                 for i in range(k)], system.put(X, y))
        gang.step()
        counts[k] = system.gpu.flops
    xq = torch.zeros((1, 600, 9), dtype=torch.int32)
    for k in (1, 3):
        cost = dispatch.declared_cost(
            "fx_matvec", xq, torch.zeros((k, 9), dtype=torch.int32), 10)
        assert cost.ops == 4 * 600 * 9 * k
        assert cost.bytes == 600 * 9 * 4 + k * 9 * 4 + 600 * k * 4
    assert counts[3] > counts[1] > 0


# ---------------------------------------------------------------------------
# fx_matvec with lanes: the plain version against the reference, per lane.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 143, 13), (1000, 16), (5, 1)])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 13])
@pytest.mark.parametrize("frac_bits", [10, 0])
def test_fx_matvec_lanes_plain_matches_reference_per_lane(shape, k,
                                                          frac_bits):
    rng = np.random.RandomState(k * 31 + shape[-1])
    x = rng.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=np.int64) \
        .astype(np.int32)                                # products wrap
    w = rng.randint(-2 ** 31, 2 ** 31 - 1, (k, shape[-1]), dtype=np.int64) \
        .astype(np.int32)
    out = dispatch.launch("fx_matvec", torch.from_numpy(x),
                          torch.from_numpy(w), frac_bits)
    assert out.dtype == torch.int32 and tuple(out.shape) == (*shape[:-1], k)
    for lane in range(k):
        ref = jfx.fx_dot(x, w[lane], frac_bits)
        np.testing.assert_array_equal(out[..., lane].numpy(), np.asarray(ref))
        np.testing.assert_array_equal(
            out[..., lane].numpy(),
            fx_matvec_plain(torch.from_numpy(x), torch.from_numpy(w[lane]),
                            frac_bits).numpy())


@pytest.mark.parametrize("version", ["int32", "hyb", "fp32"])
def test_lane_kernel_rows_equal_serial_kernel(version):
    """The serial per-core kernel given lane weights: lane k of every
    partial is the serial kernel's partial for lane k's weights."""
    rng = np.random.RandomState(5)
    cfg = tlin.GdConfig(version=version)
    kern = tlin.build_local_grad(cfg)
    if version == "fp32":
        X = torch.from_numpy(rng.randn(3, 20, 6).astype(np.float32))
        W = torch.from_numpy(rng.randn(4, 6).astype(np.float32))
        B = torch.from_numpy(rng.randn(4).astype(np.float32))
        y = torch.from_numpy(rng.randn(3, 20).astype(np.float32))
    else:
        xdt, wdt = ((torch.int32, torch.int32) if version == "int32"
                    else (torch.int8, torch.int16))
        X = torch.from_numpy(rng.randint(-100, 100, (3, 20, 6))).to(xdt)
        W = torch.from_numpy(rng.randint(-900, 900, (4, 6))).to(wdt)
        B = torch.from_numpy(rng.randint(-900, 900, 4)).to(torch.int32)
        y = torch.from_numpy(rng.randint(-900, 900, (3, 20))).to(torch.int32)
    mask = torch.from_numpy(rng.rand(3, 20) < 0.9).to(y.dtype)
    lanes = kern(X, y, mask, W, B)
    assert tuple(lanes["gw"].shape) == (3, 4, 6)
    assert tuple(lanes["gb"].shape) == (3, 4)
    for k in range(4):
        one = kern(X, y, mask, W[k], B[k])
        if version == "fp32":
            torch.testing.assert_close(lanes["gw"][:, k], one["gw"],
                                       rtol=FP32_RTOL, atol=FP32_ATOL)
            torch.testing.assert_close(lanes["gb"][:, k], one["gb"],
                                       rtol=FP32_RTOL, atol=FP32_ATOL)
        else:
            assert torch.equal(lanes["gw"][:, k], one["gw"])
            assert torch.equal(lanes["gb"][:, k], one["gb"])
