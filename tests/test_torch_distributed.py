"""The port's distributed layer against the JAX package, on the CPU.

One group of 8 gloo ranks (``spawn_ranks``; the rank body is
``tests/torch_ranks.py::distributed_body``, which imports no JAX) runs
every collective case; the test's main process computes the reference on
the same numpy inputs:

* ``compress_decompress_psum`` and ``ef_compress_psum`` on 4 ranks (a
  "data" group of a (2, 4) mesh) and on 8, against the reference under a
  named ``jax.vmap``: bit-identical outputs and error buffers;
* ``hierarchical_psum`` / ``hierarchical_pmean`` on (2, 4) against the
  flat sum and the reference under nested ``vmap`` (``HIER_RTOL``), the
  odd-leading-dim fallback included;
* placements on a (2, 2, 2) ("pod", "data", "model") mesh and on its
  (2, 2) ("data", "model") submeshes: each rank's local shard is the
  slice its spec names; ``constrain``;
* the GPipe pipeline (4 stages along "data", one pipeline a pod) against
  the sequential oracle of ``tests/test_pipeline.py`` computed in JAX.

Without ranks: every reduced arch's parameter specs against the
reference's, the sharding helpers on synthetic shapes and meshes (the
reference's on ``AbstractMesh``), the activation specs, ``describe``,
``split_stages``, ``bubble_fraction`` and the byte counts; and
``spawn_ranks``' failure and timeout paths.
"""
import functools
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import ARCH_IDS as JARCHS
from repro.configs.base import get_config as jget_config
from repro.distributed import act_sharding as jact
from repro.distributed import collectives as jcoll
from repro.distributed import pipeline as jpipe
from repro.distributed import sharding as jshard
from repro.launch import mesh as jmesh
from repro.models.api import Model as JModel
from repro.optim import grad_compression as jgc

from repro_torch.configs.base import get_config
from repro_torch.distributed import act_sharding as tact
from repro_torch.distributed import collectives as tcoll
from repro_torch.distributed import pipeline as tpipe
from repro_torch.distributed import sharding as tshard
from repro_torch.launch.mesh import backend_for, describe, spawn_ranks
from repro_torch.models.api import params_from_jax, stacked_groups
from repro_torch.optim import grad_compression as tgc

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

#: the hierarchical sum against the flat one (tests/test_collectives.py)
HIER_RTOL = 1e-6
#: the pipeline against the sequential oracle: forward as
#: tests/test_pipeline.py; gradients (float32 in another order, 8 tanh
#: layers) to this share of the largest gradient (that test's 1e-4)
PIPE_FWD_ATOL, PIPE_GRAD_RTOL = 1e-5, 1e-4
#: the pipeline oracle's size (tests/test_pipeline.py)
PIPE_L, PIPE_D, PIPE_MICRO, PIPE_B, PIPE_S = 8, 32, 6, 2, 4
PLACE_SPECS = [("model", None), (None, "model", None),
               (("pod", "data"), None, "model"), ("data", "model", None),
               (None, ("data", "model"), None), (None, None, "pod"),
               (("pod", "data", "model"),), ()]
SQUARE_SPECS = [("data", "model"), ("model", "data"), (None, ("data", "model")),
                ("data",), (None, None, "model"), ()]
MESHES = {"data x model": ((2, 4), ("data", "model")),
          "pod x data x model": ((2, 2, 2), ("pod", "data", "model")),
          "production": ((16, 16), ("data", "model")),
          "multi-pod": ((2, 16, 16), ("pod", "data", "model")),
          "pod x data": ((2, 4), ("pod", "data")),
          "model": ((4,), ("model",))}
#: the meshes the parameter and cache rules apply to: the reference's
#: raise on a mesh without "model"
RULE_MESHES = [k for k in MESHES if "model" in MESHES[k][1]]


def _compress_inputs(world: int) -> dict:
    rng = np.random.RandomState(world)
    ties = np.tile(np.arange(-6, 7, dtype=np.float32) + 0.5, (world, 1))
    ties[0, 0] = 127.0      # amax 127: scale 1, every other value a tie
    cases = {
        "normal": (rng.normal(0, 1, (world, 257)),
                   rng.normal(0, 0.01, (world, 257)), "float32"),
        "matrix": (rng.normal(0, 3e-3, (world, 24, 40)),
                   rng.normal(0, 1e-5, (world, 24, 40)), "float32"),
        "ties": (ties, np.zeros_like(ties), "float32"),
        "zeros": (np.zeros((world, 33)), np.zeros((world, 33)), "float32"),
        "bf16": (rng.normal(0, 2, (world, 100)),
                 rng.normal(0, 0.01, (world, 100)), "bfloat16"),
    }
    return {k: (g.astype(np.float32), e.astype(np.float32), dt)
            for k, (g, e, dt) in cases.items()}


def _reference_compress(g, err, dtype, world):
    jg = jnp.asarray(g, dtype)
    psum = jax.vmap(lambda x: jgc.compress_decompress_psum(x, "data"),
                    axis_name="data")(jg)
    mean, new_err = jax.vmap(
        lambda x, e: jgc.ef_compress_psum(x, e, "data", world),
        axis_name="data")(jg, jnp.asarray(err))
    return {"psum": np.asarray(psum, np.float32),
            "mean": np.asarray(mean), "err": np.asarray(new_err)}


def _pipe_oracle() -> dict:
    """tests/test_pipeline.py's inputs, forward and gradients."""
    w = jax.random.normal(jax.random.PRNGKey(0), (PIPE_L, PIPE_D, PIPE_D)) \
        * (1.0 / np.sqrt(PIPE_D))
    b = jnp.zeros((PIPE_L, PIPE_D))
    xs = jax.random.normal(jax.random.PRNGKey(1),
                           (PIPE_MICRO, PIPE_B, PIPE_S, PIPE_D))

    def sequential(params):
        def body(h, wb):
            return jnp.tanh(h @ wb[0] + wb[1]), None
        return jnp.stack([jax.lax.scan(body, xs[i], (params["w"],
                                                     params["b"]))[0]
                          for i in range(PIPE_MICRO)])
    params = {"w": w, "b": b}
    grads = jax.grad(lambda p: jnp.sum(sequential(p) ** 2))(params)
    return {"w": np.asarray(w), "b": np.asarray(b), "xs": np.asarray(xs),
            "out": np.asarray(sequential(params)),
            "grads": {k: np.asarray(v) for k, v in grads.items()}}


def _hier_inputs() -> dict:
    """tests/test_collectives.py's x and y, rows split over 8 ranks."""
    x = np.arange(8 * 12, dtype=np.float32).reshape(8 * 4, 3) / 7.0
    y = np.arange(8 * 5 * 3, dtype=np.float32).reshape(8 * 5, 3)
    return {"even": x.reshape(8, 4, 3), "odd": y.reshape(8, 5, 3)}


@pytest.fixture(scope="module")
def ranks():
    inputs = {"compress4": _compress_inputs(4),
              "compress8": _compress_inputs(8),
              "hier": _hier_inputs(),
              "place": np.arange(8 * 12 * 4, dtype=np.float32).reshape(
                  8, 12, 4),
              "place_specs": PLACE_SPECS, "square_specs": SQUARE_SPECS}
    oracle = _pipe_oracle()
    inputs["pipe"] = {k: oracle[k] for k in ("w", "b", "xs")}
    results = spawn_ranks(torch_ranks.distributed_body, 8, args=(inputs,),
                          device="cpu", timeout=240)
    return inputs, results, oracle


def test_the_ranks_import_no_jax(ranks):
    _, results, _ = ranks
    assert not any(r["jax"] for r in results)


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("case", ["normal", "matrix", "ties", "zeros",
                                  "bf16"])
def test_compress_collectives_are_bit_identical(ranks, world, case):
    inputs, results, _ = ranks
    g, err, dtype = inputs[f"compress{world}"][case]
    want = _reference_compress(g, err, dtype, world)
    for rank, r in enumerate(results):
        index = rank % 4 if world == 4 else rank
        got = r[f"compress{world}"][case]
        for key in ("psum", "mean", "err"):
            np.testing.assert_array_equal(got[key], want[key][index],
                                          err_msg=f"{key} on rank {rank}")


def test_compress_ties_round_half_to_even(ranks):
    _, results, _ = ranks
    got = results[0]["compress4"]["ties"]["psum"]
    # 4 ranks of k + 0.5 at scale 1: each rounds to the even neighbour
    want = 4 * np.round(np.arange(-6, 7) + 0.5)
    np.testing.assert_array_equal(got[1:], want[1:])


@pytest.mark.parametrize("name", ["even", "odd"])
def test_hierarchical_psum_matches_flat_and_reference(ranks, name):
    inputs, results, _ = ranks
    x = inputs["hier"][name]
    flat = x.sum(0)
    nested = jax.vmap(jax.vmap(
        functools.partial(jcoll.hierarchical_psum, intra_axis="data",
                          inter_axis="pod"), axis_name="data"),
        axis_name="pod")(jnp.asarray(x.reshape(2, 4, *x.shape[1:])))
    nested_mean = jax.vmap(jax.vmap(
        functools.partial(jcoll.hierarchical_pmean, intra_axis="data",
                          inter_axis="pod"), axis_name="data"),
        axis_name="pod")(jnp.asarray(x.reshape(2, 4, *x.shape[1:])))
    for rank, r in enumerate(results):
        np.testing.assert_allclose(r[f"hier_{name}"], flat, rtol=HIER_RTOL)
        np.testing.assert_allclose(r[f"hier_{name}"],
                                   np.asarray(nested)[rank // 4, rank % 4],
                                   rtol=HIER_RTOL)
        np.testing.assert_allclose(r[f"hmean_{name}"],
                                   np.asarray(nested_mean)[rank // 4,
                                                           rank % 4],
                                   rtol=HIER_RTOL)


def test_hierarchical_psum_moves_what_its_schedule_says(ranks):
    """Per rank, even rows (4 x 3 float32 = 48 bytes): reduce-scatter
    hands 48, the cross-pod all-reduce a quarter, the all-gather a
    quarter; odd rows fall back to two all-reduces of 60 bytes.  Each
    sum is done twice (psum and pmean); nothing is staged on the CPU."""
    _, results, _ = ranks
    for r in results:
        t = r["traffic"]
        assert t["reduce_scatter"] == 2 * 48
        assert t["all_gather"] == 2 * 12
        assert t["all_reduce"] == 2 * (12 + 2 * 60)
        assert t.get("staged", 0) == 0


def _named_slice(full, spec, coord: dict):
    """The block of ``full`` that ``spec`` gives the rank at ``coord`` (every
    mesh axis of size 2), axes of a dim taken in mesh order."""
    index = []
    for dim, s in enumerate(spec + (None,) * (full.ndim - len(spec))):
        axes = () if s is None else (s,) if isinstance(s, str) else s
        n, k = 1, 0
        for a in axes:
            n, k = n * 2, k * 2 + coord[a]
        size = full.shape[dim] // n
        index.append(slice(k * size, (k + 1) * size))
    return full[tuple(index)]


@pytest.mark.parametrize("i", range(len(PLACE_SPECS)))
def test_placed_shard_is_the_slice_its_spec_names(ranks, i):
    inputs, results, _ = ranks
    full = inputs["place"]
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 2, 2))
    spec = tshard.validate_divisibility(PLACE_SPECS[i], full.shape, mesh)
    for r in results:
        coord = dict(zip(mesh.mesh_dim_names, r["coord"]))
        np.testing.assert_array_equal(r["placed"][i],
                                      _named_slice(full, spec, coord))


@pytest.mark.parametrize("i", range(len(SQUARE_SPECS)))
def test_placed_shard_on_a_2x2_mesh_is_the_slice_its_spec_names(ranks, i):
    """A (2, 2) ("data", "model") mesh: each pod's submesh of the cube."""
    inputs, results, _ = ranks
    full = inputs["place"]
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    spec = tshard.validate_divisibility(SQUARE_SPECS[i], full.shape, mesh)
    for r in results:
        coord = dict(zip(mesh.mesh_dim_names, r["square_coord"]))
        assert coord == dict(zip(("data", "model"), r["coord"][1:]))
        np.testing.assert_array_equal(r["square_placed"][i],
                                      _named_slice(full, spec, coord))


def test_constrain_redistributes_dtensors_only(ranks):
    inputs, results, _ = ranks
    full = inputs["place"]
    for r in results:
        pod, data, _ = r["coord"]
        k = 2 * pod + data          # "btd": batch over ("pod", "data")
        np.testing.assert_array_equal(r["constrained"],
                                      full[2 * k:2 * k + 2])
        assert r["plain_unchanged"] and r["no_mesh_unchanged"]


def test_pipeline_matches_the_sequential_oracle(ranks):
    _, results, oracle = ranks
    per = PIPE_L // torch_ranks.PIPE_STAGES
    for r in results:
        assert np.abs(r["pipe_out"] - oracle["out"]).max() < PIPE_FWD_ATOL
        np.testing.assert_array_equal(r["pipe_out_no_grad"], r["pipe_out"])
    for pod in range(2):
        for key in ("w", "b"):
            got = np.concatenate([results[4 * pod + s]["pipe_grads"][key]
                                  for s in range(4)])
            want = oracle["grads"][key]
            assert got.shape == want.shape
            rel = np.abs(got - want).max() / np.abs(want).max()
            assert rel < PIPE_GRAD_RTOL, (key, rel)
    # each stage holds its own layers' gradient, not world times it
    for s in range(4):
        got = results[s]["pipe_grads"]["w"]
        want = oracle["grads"]["w"][s * per:(s + 1) * per]
        np.testing.assert_allclose(np.linalg.norm(got), np.linalg.norm(want),
                                   rtol=PIPE_GRAD_RTOL)


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_describe_of_any_shape_matches_the_reference(mesh_key):
    tmesh, jm = _meshes(mesh_key)
    assert describe(tmesh) == jmesh.describe(jm)


def test_describe_matches_the_reference(ranks):
    _, results, _ = ranks
    for (shape, axes), got in zip([((2, 4), ("pod", "data")),
                                   ((2, 2, 2), ("pod", "data", "model"))],
                                  results[0]["describe"]):
        assert got == jmesh.describe(AbstractMesh(shape, axes))


# -- spawn_ranks -----------------------------------------------------------------

def test_a_failing_rank_raises_its_traceback_and_stops_the_group():
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails on purpose") as info:
        spawn_ranks(torch_ranks.failing_body, 2, device="cpu",
                    timeout=60)
    assert "Traceback" in str(info.value)
    assert time.monotonic() - t0 < 45


def test_a_group_past_its_timeout_is_killed():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn_ranks(torch_ranks.sleeping_body, 1, device="cpu",
                    timeout=8)
    assert time.monotonic() - t0 < 30


def test_the_backend_follows_the_device():
    assert backend_for("cpu", 4) == "gloo"
    if torch.cuda.device_count() < 2:     # ranks sharing a GPU: gloo
        assert backend_for("cuda", 2) == "gloo"


# -- parameter specs ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _arch_leaves(arch: str):
    """(the reference's leaves as (path, shape), the port's leaves as
    name -> (reference leaf index, shape))."""
    jc = jget_config(arch).reduced()
    shapes = jax.eval_shape(JModel(jc).init, jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(s.shape, i, np.float32)
                  for i, (_, s) in enumerate(flat)])
    port = params_from_jax(get_config(arch).reduced(), ids, device="cpu")
    named = {n: (int(p.flatten()[0]), tuple(p.shape))
             for n, p in port.named_parameters()}
    return [(path, s) for path, s in flat], named, shapes


def _ref_spec(path, shape) -> tuple:
    return tuple(jshard.spec_for_param(path, SimpleNamespace(
        ndim=len(shape), shape=shape)))


def _per_layer(want: tuple) -> tuple:
    return want[1:] if want else want


@pytest.mark.parametrize("arch", JARCHS)
def test_param_specs_match_the_reference(arch):
    ref, named, _ = _arch_leaves(arch)
    assert len(set(i for i, _ in named.values())) == len(ref)
    for name, (i, shape) in named.items():
        path, ref_shape = ref[i]
        want = _ref_spec(path, tuple(ref_shape.shape))
        if len(shape) < len(ref_shape.shape):       # one layer of a stack
            assert want[:1] in ((), (None,)), (name, want)
            want = _per_layer(want)
        assert tshard.spec_for_param(name, shape) == want, name


def _meshes(key):
    shape, axes = MESHES[key]
    return (SimpleNamespace(mesh_dim_names=axes, shape=shape),
            AbstractMesh(shape, axes))


@pytest.mark.parametrize("mesh_key", RULE_MESHES)
@pytest.mark.parametrize("fn", ["tp", "replicated_backbone", "fsdp",
                                "opt_state"])
@pytest.mark.parametrize("arch", JARCHS)
def test_param_shardings_match_the_reference(arch, fn, mesh_key):
    ref, named, shapes = _arch_leaves(arch)
    tmesh, jmesh_ = _meshes(mesh_key)
    tfn, jfn = {
        "tp": (tshard.param_shardings, jshard.param_shardings),
        "replicated_backbone": (
            functools.partial(tshard.param_shardings, tp_dense=False),
            functools.partial(jshard.param_shardings, tp_dense=False)),
        "fsdp": (tshard.param_shardings_fsdp, jshard.param_shardings_fsdp),
        "opt_state": (tshard.opt_state_shardings,
                      jshard.opt_state_shardings)}[fn]
    want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        jfn(jmesh_, shapes), is_leaf=lambda x: hasattr(x, "spec"))]
    got = tfn(tmesh, {n: shape for n, (_, shape) in named.items()})
    for name, (i, shape) in named.items():
        w = want[i]
        if len(shape) < len(ref[i][1].shape):
            if w[:1] not in ((), (None,)):
                # the reference shards the stacked layer axis itself (FSDP
                # of a leaf whose largest dim is its layers); a port layer
                # has no such axis, and its spec is that layer's
                assert fn in ("fsdp", "opt_state"), (name, w)
                continue
            w = _per_layer(w)
        assert got[name] == w, (name, got[name], w)


SPEC_CASES = [(("model", None), (7, 3)), (("model", None), (32, 3)),
              ((("pod", "data"), "model"), (8, 64)),
              ((("data",), None), (6, 2)), ((None, None, "data"), (2, 3, 16)),
              ((), (4, 4)), (("data", None), (5, 5))]


def _axes(spec) -> set:
    return {a for s in spec if s is not None
            for a in ((s,) if isinstance(s, str) else s)}


@pytest.mark.parametrize("mesh_key,spec,shape", [
    (key, spec, shape) for key in MESHES for spec, shape in SPEC_CASES
    if _axes(spec) <= set(MESHES[key][1])])
def test_validate_and_extend_match_the_reference(mesh_key, spec, shape):
    from jax.sharding import PartitionSpec as P
    tmesh, jm = _meshes(mesh_key)
    v = jshard.validate_divisibility(P(*spec), shape, jm)
    assert tshard.validate_divisibility(spec, shape, tmesh) == tuple(v)
    assert tshard.extend_with_dp(tuple(v), shape, tmesh) == tuple(
        jshard.extend_with_dp(v, shape, jm))


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_batch_shardings_match_the_reference(mesh_key):
    tmesh, jm = _meshes(mesh_key)
    batch = {"tokens": (8, 16), "targets": (8, 16), "odd": (3, 4),
             "vision": (16, 4, 8), "step": ()}
    want = jshard.batch_shardings(jm, {k: np.zeros(s) for k, s in
                                       batch.items()})
    got = tshard.batch_shardings(tmesh, batch)
    assert got == {k: tuple(v.spec) for k, v in want.items()}


@pytest.mark.parametrize("mesh_key", RULE_MESHES)
def test_cache_shardings_match_the_reference(mesh_key):
    """The reference's stacked caches (reps, B, ...) against the port's
    per-layer list, and the encoder-decoder's dict of per-layer lists."""
    tmesh, jm = _meshes(mesh_key)
    reps, b = 3, 8
    layer = {"k": (b, 4, 32, 16), "v": (b, 4, 32, 16), "ck": (b, 6, 10, 16),
             "conv": (b, 3, 64), "state": (b, 64), "tiny": (b,)}
    stacked = {k: np.zeros((reps, *s)) for k, s in layer.items()}
    want = {k: tuple(v.spec) for k, v in jshard.cache_shardings(
        jm, stacked).items()}
    got = tshard.cache_shardings(tmesh, [{k: np.zeros(s) for k, s in
                                          layer.items()}] * reps)
    for g in got:
        assert g == {k: w[1:] for k, w in want.items()}
    enc = {"k": [np.zeros(layer["k"])] * reps, "length": 5,
           "pos": np.zeros((32, 64))}
    want_enc = jshard.cache_shardings(jm, {
        "k": np.zeros((reps, *layer["k"])), "length": jnp.int32(5),
        "pos": np.zeros((32, 64))})
    got_enc = tshard.cache_shardings(tmesh, enc)
    assert got_enc["k"] == [tuple(want_enc["k"].spec)[1:]] * reps
    assert got_enc["length"] == tuple(want_enc["length"].spec)
    assert got_enc["pos"] == tuple(want_enc["pos"].spec)


def test_dp_axes_match_the_reference():
    for key in MESHES:
        tmesh, jm = _meshes(key)
        assert tshard.dp_axes(tmesh) == jshard.dp_axes(jm)


# -- activation specs ----------------------------------------------------------------

@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_activation_specs_match_the_reference(monkeypatch, seq_parallel,
                                              mesh_key):
    monkeypatch.setattr(jact, "SEQ_PARALLEL", seq_parallel)
    monkeypatch.setattr(tact, "SEQ_PARALLEL", seq_parallel)
    tmesh, jm = _meshes(mesh_key)
    for kind in ("btd", "bhsd", "btf", "ecd", "gecd", "btv", "bdp", "none"):
        for ndim in range(1, 6):
            want = jact._spec_for(kind, ndim, jm)
            got = tact._spec_for(kind, ndim, tmesh)
            assert got == (None if want is None else tuple(want)), (kind,
                                                                    ndim)


def test_constrain_without_a_mesh_and_use_mesh_nest():
    x = torch.zeros(2, 3, 4)
    assert tact.constrain(x, "btd") is x and tact.current_mesh() is None
    a, b = object(), object()
    with tact.use_mesh(a):
        with tact.use_mesh(b):
            assert tact.current_mesh() is b
        assert tact.current_mesh() is a
        assert tact.constrain(x, "btd") is x       # a plain tensor
    assert tact.current_mesh() is None


def test_seq_parallel_reads_the_reference_switch():
    import os
    assert tact.SEQ_PARALLEL == (os.environ.get("REPRO_SEQ_PARALLEL",
                                                "0") == "1")
    assert tact.SEQ_PARALLEL == jact.SEQ_PARALLEL


# -- small functions ---------------------------------------------------------------

@pytest.mark.parametrize("n_stages,n_micro", [(4, 12), (1, 8), (4, 6),
                                              (2, 1), (8, 32)])
def test_bubble_fraction_matches_the_reference(n_stages, n_micro):
    assert tpipe.bubble_fraction(n_stages, n_micro) == \
        jpipe.bubble_fraction(n_stages, n_micro)


def test_split_stages_matches_the_reference():
    x = np.arange(8 * 3 * 5, dtype=np.float32).reshape(8, 3, 5)
    want = jpipe.split_stages({"w": jnp.asarray(x), "n": {"b": x[:, 0]}}, 4)
    got = tpipe.split_stages({"w": torch.from_numpy(x),
                              "n": {"b": torch.from_numpy(x[:, 0])}}, 4)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["n"]["b"].numpy(),
                                  np.asarray(want["n"]["b"]))
    with pytest.raises(ValueError, match="do not split"):
        tpipe.split_stages({"w": torch.zeros(6, 2)}, 4)


@pytest.mark.parametrize("n_bytes,pod", [(1 << 30, 16), (1000, 3), (7, 2)])
def test_cross_pod_bytes_match_the_reference(n_bytes, pod):
    assert tcoll.cross_pod_bytes(n_bytes, pod) == \
        jcoll.cross_pod_bytes(n_bytes, pod)


@pytest.mark.parametrize("arch", JARCHS)
def test_byte_counts_and_stacked_groups_match_the_reference(arch):
    ref, named, shapes = _arch_leaves(arch)
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   shapes)
    tree = {n: torch.zeros(s) for n, (_, s) in named.items()}
    assert tgc.compressed_bytes_saved(tree) == \
        jgc.compressed_bytes_saved(zeros)
    # one group a reference leaf, its layers in order
    groups = stacked_groups(get_config(arch).reduced(), list(tree))
    assert len(groups) == len(ref)
    for g in groups:
        assert len({named[n][0] for n in g}) == 1
        layers = [int(n.split(".")[1]) for n in g if len(g) > 1]
        assert layers == sorted(layers)
    err = tgc.init_error_buffers(tree)
    assert all(e.dtype == torch.float32 and not e.any() for e in
               err.values())
