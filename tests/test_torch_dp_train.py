"""The port's data-parallel trainer against the reference's, on the CPU.

One reference subprocess forces 4 host devices and runs the reference's
own ``make_dp_train_step`` (jitted) on reduced granite-3-8b: 3 steps each
exact on a ``(4,)`` ``("data",)`` mesh, exact on a ``(2, 2)`` ``("pod",
"data")`` mesh (the hierarchical reduction) and compressed on ``(4,)``,
over MarkovCorpus batches of 8 x 16 tokens (2 rows a rank).  It saves the
losses, grad norms and final params, and for the compressed run its
step-1 gradient (its ``_dp_call``, jitted) and every device's error
buffers after step 1.  Meanwhile the port runs the same steps on 4 gloo
ranks (``spawn_ranks``; the rank bodies are ``tests/torch_ranks.py``,
which imports no JAX) from the reference's initial parameters through
``params_from_jax``.

Tolerances.  Exact runs: those ``tests/test_torch_lm_train.py`` holds the
one-device step to (losses within ``LOSS_ATOL``, grad norms within
``GRAD_RTOL``, each leaf's 3-step update within ``STEP_UPDATE_RTOL`` of
the reference's).  Compressed: each rank quantizes its float32 gradient,
which differs from the reference's by float error, so an element within
that error of a rounding tie may round to the neighbouring int8 level on
one rank: the step-1 mean gradient is held within one quantum (``scale /
world``) of the reference's per element, and each rank's step-1 error
buffers equal to float error or one quantum off its device's.  Then AdamW,
which moves an element by about lr whatever its gradient's size, moves
such an element differently, every later gradient shifts, and the error
buffers (the rounding residues) decorrelate; the losses are held to
``EF_LOSS_ATOL``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as jget_config
from repro.models.api import Model as JModel

from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.api import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH, BATCH, SEQ, STEPS, LR, WORLD = "granite-3-8b", 8, 16, 3, 1e-3, 4
RUNS = {"flat": ((4,), ("data",), False),
        "pod": ((2, 2), ("pod", "data"), False),
        "compressed": ((4,), ("data",), True)}
#: tests/test_torch_lm_train.py's tolerances for the one-device step
LOSS_ATOL, GRAD_RTOL, STEP_UPDATE_RTOL = 1e-5, 1e-4, 1e-3
#: compressed runs (module docstring): 3 losses (1.5e-5 observed); the
#: step-1 error buffers within EF_FLOAT_QUANTA of a quantum of the
#: reference's or one quantum away (3.2e-4 observed), flipped on at most
#: EF_MAX_FLIP_SHARE of the elements (39 of 3,410,432 observed)
EF_LOSS_ATOL, EF_FLOAT_QUANTA, EF_MAX_FLIP_SHARE = 1e-4, 1e-3, 1e-3
#: the reference's own bound between its hierarchical and flat trainers
POD_RTOL = 1e-4

REF_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_config
from repro.data.tokens import MarkovCorpus
from repro.models.api import Model
from repro.optim.adam import AdamW
from repro.optim.grad_compression import init_error_buffers
from repro.train.loop import _dp_call, make_dp_train_step

arch, batch, seq, steps, lr = %(arch)r, %(batch)d, %(seq)d, %(steps)d, %(lr)r
runs = %(runs)r
cfg = get_config(arch).reduced()
model = Model(cfg)
out = {}
leaves = jax.tree_util.tree_leaves
for i, x in enumerate(leaves(model.init(jax.random.PRNGKey(0)))):
    out[f"init/{i}"] = np.asarray(x)
for name, (shape, axes, compress) in runs.items():
    mesh = jax.make_mesh(shape, axes)
    params = model.init(jax.random.PRNGKey(0))
    opt = AdamW(lr=lr)
    opt_state, err = opt.init(params), init_error_buffers(params)
    step = jax.jit(make_dp_train_step(model, opt, mesh, compress=compress))
    corpus = MarkovCorpus(cfg.vocab_size, seed=0)
    losses, norms = [], []
    for s in range(steps):
        b = jax.tree_util.tree_map(jnp.asarray, corpus.batch(batch, seq))
        if compress and s == 0:
            call = jax.jit(lambda p, e, bb: _dp_call(
                mesh, "data", model, p, e, bb, True, 4))
            with mesh:
                (_, g), _ = call(params, err, b)
            for i, x in enumerate(leaves(g)):
                out[f"{name}/step1_grads/{i}"] = np.asarray(x)
        with mesh:
            params, opt_state, err, m = step(params, opt_state, err, b)
        if compress and s == 0:
            for i, x in enumerate(leaves(err)):
                shards = sorted(x.addressable_shards,
                                key=lambda sh: sh.device.id)
                out[f"{name}/err1/{i}"] = np.stack([np.asarray(sh.data)
                                                    for sh in shards])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[f"{name}/loss"] = np.asarray(losses)
    out[f"{name}/grad_norm"] = np.asarray(norms)
    for i, x in enumerate(leaves(params)):
        out[f"{name}/params/{i}"] = np.asarray(x)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, port results per rank, the tree's structure)."""
    path = tmp_path_factory.mktemp("dp") / "ref.npz"
    code = REF_CODE % dict(arch=ARCH, batch=BATCH, seq=SEQ, steps=STEPS,
                           lr=LR, runs=RUNS)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", code, str(ROOT / "src"),
                            str(path)], env=env, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        jm = JModel(jget_config(ARCH).reduced())
        init = jm.init(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, init)
        port = spawn_ranks(torch_ranks.dp_train_body, WORLD,
                           args=(ARCH, tree, RUNS, BATCH, SEQ, STEPS, LR),
                           device="cpu", timeout=300)
        _, stderr = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, stderr[-3000:]
    data = dict(np.load(path))
    treedef = jax.tree_util.tree_structure(init)
    return data, port, treedef, tree


def _named(data: dict, prefix: str, treedef, index=None) -> dict:
    """A saved reference tree (leaves ``prefix/i``) under the port's
    names; ``index`` picks one device's row of stacked shards."""
    n = treedef.num_leaves
    leaves = [data[f"{prefix}/{i}"] for i in range(n)]
    if index is not None:
        leaves = [x[index] for x in leaves]
    tree = jax.tree_util.tree_unflatten(treedef, leaves)
    return {k: v.detach().numpy() for k, v in params_from_jax(
        get_config(ARCH).reduced(), tree, device="cpu").named_parameters()}


def test_the_ranks_import_no_jax_and_start_from_the_reference(runs):
    data, port, treedef, tree = runs
    assert not any(r["jax"] for r in port)
    for i, x in enumerate(jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(x, data[f"init/{i}"])


@pytest.mark.parametrize("name", list(RUNS))
def test_params_stay_bit_identical_on_every_rank(runs, name):
    _, port, _, _ = runs
    digests = [r[name]["digest"] for r in port]
    assert len(digests[0]) == STEPS
    assert all(d == digests[0] for d in digests[1:])
    for n, p in port[0][name]["params"].items():
        for r in port[1:]:
            np.testing.assert_array_equal(r[name]["params"][n], p)


@pytest.mark.parametrize("name", ["flat", "pod"])
def test_exact_runs_match_the_reference(runs, name):
    data, port, treedef, _ = runs
    got = port[0][name]
    np.testing.assert_allclose(got["loss"], data[f"{name}/loss"], rtol=0,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(got["grad_norm"], data[f"{name}/grad_norm"],
                               rtol=GRAD_RTOL)
    before = _named(data, "init", treedef)
    want = _named(data, f"{name}/params", treedef)
    for n, p in got["params"].items():
        moved, want_moved = p - before[n], want[n] - before[n]
        err = np.linalg.norm(moved - want_moved) / np.linalg.norm(want_moved)
        assert err <= STEP_UPDATE_RTOL, (n, err)


def test_a_step_hands_collectives_what_its_reduction_says(runs):
    """Bytes a rank hands to collectives in a step (float32 reduced
    granite, n elements): the flat mean all-reduces 4n; the hierarchical
    sum on (2, 2) reduce-scatters 4n, all-reduces and all-gathers the
    half-size shards; the compressed one all-reduces an int32 payload of
    4n and one float32 scale a reference leaf.  Each adds the loss's 4
    bytes; nothing is staged on the CPU."""
    _, port, treedef, _ = runs
    n = sum(p.size for p in port[0]["flat"]["params"].values())
    got = {name: port[0][name]["traffic"] for name in RUNS}
    assert got["flat"]["all_reduce"] == 4 * n + 4
    assert (got["pod"]["reduce_scatter"], got["pod"]["all_reduce"],
            got["pod"]["all_gather"]) == (4 * n, 2 * n + 4, 2 * n)
    assert got["compressed"]["all_reduce"] == \
        4 * n + 4 * treedef.num_leaves + 4
    assert not any("staged" in t for t in got.values())


def test_hierarchical_losses_match_the_flat_reduction(runs):
    _, port, _, _ = runs
    np.testing.assert_allclose(port[0]["pod"]["loss"],
                               port[0]["flat"]["loss"], rtol=POD_RTOL)


def test_compressed_step1_gradient_within_one_quantum(runs):
    data, port, treedef, _ = runs
    got = port[0]["compressed"]
    want = _named(data, "compressed/step1_grads", treedef)
    flips = total = 0
    for n, g in got["step1_grads"].items():
        quantum = got["step1_scales"][n] / WORLD
        diff = np.abs(g - want[n])
        assert diff.max() <= quantum * 1.001, (n, diff.max(), quantum)
        flips += int((diff > 0.5 * quantum).sum())
        total += diff.size
    # a flip is the exception
    assert flips <= EF_MAX_FLIP_SHARE * total, (flips, total)


def test_compressed_losses_and_step1_error_buffers_match_the_reference(
        runs):
    """Each rank's error buffers after step 1 against that device's: equal
    to float error, or one quantum apart where the rank's rounding
    flipped (``c - q * scale`` with q one level off)."""
    data, port, treedef, _ = runs
    got = port[0]["compressed"]
    np.testing.assert_allclose(got["loss"], data["compressed/loss"], rtol=0,
                               atol=EF_LOSS_ATOL)
    assert got["loss"][-1] < got["loss"][0]
    flips = total = 0
    for rank, r in enumerate(port):
        want = _named(data, "compressed/err1", treedef, index=rank)
        scales = r["compressed"]["step1_scales"]
        for n, e in r["compressed"]["err1"].items():
            d = np.abs(e - want[n]) / scales[n]
            assert np.all(np.minimum(d, np.abs(d - 1)) <= EF_FLOAT_QUANTA), n
            flips += int((d > 0.5).sum())
            total += d.size
    assert flips <= EF_MAX_FLIP_SHARE * total, (flips, total)


def test_dp_step_refuses_what_it_cannot_run():
    """A mesh with other axes than pod/data and a batch the data axes do
    not divide raise (no process group needed: a stand-in mesh)."""
    from types import SimpleNamespace
    from repro_torch.train import loop
    with pytest.raises(ValueError, match="make_train_step"):
        loop.make_dp_train_step(None, None, SimpleNamespace(
            mesh_dim_names=("data", "model"), shape=(2, 2)))
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data"), shape=(2, 2),
                           get_coordinate=lambda: (1, 0))
    rows = loop.local_rows({"tokens": np.arange(8)[:, None],
                            "step": np.int32(3)}, mesh)
    np.testing.assert_array_equal(rows["tokens"][:, 0], [4, 5])
    assert rows["step"] == 3
    with pytest.raises(ValueError, match="not a multiple"):
        loop.local_rows({"tokens": np.zeros((6, 2))}, mesh)
