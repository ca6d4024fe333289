"""The port's examples (``src/repro_torch/examples``) on the CPU.

Each is held to the JAX package's printed output,
``src/repro_torch/examples/expected/<name>.txt`` (which
``tests/test_torch_examples_ref.py`` holds to the reference's scripts):

* ``elastic_jobs`` and ``job_queue`` run whole through ``main(["--device",
  "cpu"])``, their output under ``outputs.compare``;
* ``serve_lm.serve`` on the reference's own weights
  (``Model(cfg).init(PRNGKey(0))``, carried through ``params_from_jax``)
  prints the reference's 8 requests, 240 tokens and first tokens;
* ``quickstart``, ``pim_ml_sklearn``, ``compare_systems`` and
  ``emb_recsys`` cost 54-140 s each whole on a CPU (eager torch against
  jit), so their ``run`` (the banner and section order ``main`` calls)
  runs at reduced sizes: every line of the file with its numbers masked
  (``outputs.skeleton``), in order, so formats and branches match.  Their numbers at full size
  are held on the card (``chip_smoke.py`` phase 19), and at small sizes
  by the ``tests/test_torch_*`` parity tests of each workload;
* ``train_lm.main`` at batch 2, seq 16 for 2 steps, the fewest at which
  its own check (the loss falls) holds, its entropy floor the
  reference's ``MarkovCorpus(8192, seed=0).entropy_bound()``;
* importing every example loads neither ``jax`` nor ``repro``, and
  ``main`` without ``--device`` raises where there is no GPU.
"""
import importlib
import os
import pkgutil
import re
import subprocess
import sys

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.data.tokens import MarkovCorpus as JMarkovCorpus
from repro.models.api import Model as JModel

import repro_torch.examples as examples
from repro_torch.configs.base import get_config
from repro_torch.examples import elastic_jobs, job_queue, serve_lm, train_lm
from repro_torch.examples.outputs import (RULES, compare, expected, mask,
                                          skeleton)
from repro_torch.models.api import Model, params_from_jax

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
NAMES = ("quickstart", "pim_ml_sklearn", "compare_systems", "emb_recsys",
         "job_queue", "elastic_jobs", "serve_lm", "train_lm")
DEV = "cpu"


@pytest.mark.parametrize("module", [elastic_jobs, job_queue],
                         ids=["elastic_jobs", "job_queue"])
def test_whole_example_matches_the_reference(module, capsys):
    module.main(["--device", DEV])
    name = module.__name__.rsplit(".", 1)[1]
    assert compare(capsys.readouterr().out, expected(name)) == []


def test_serve_on_the_references_weights_prints_its_tokens(capsys):
    """Greedy tokens with ``quantize_dense`` off: equal, as
    ``tests/test_torch_lm.py::test_serve_engine_matches_the_reference``
    holds them."""
    cfg = get_config("qwen3-8b").reduced()
    tree = jax.tree_util.tree_map(
        np.asarray,
        JModel(jget_config("qwen3-8b").reduced()).init(jax.random.PRNGKey(0)))
    done = serve_lm.serve(Model(cfg, device=DEV),
                          params_from_jax(cfg, tree, device=DEV))
    out = capsys.readouterr().out
    assert len(done) == 8 and sum(len(r.output) for r in done) == 240
    assert compare(out, expected("serve_lm")) == []


_SMALL = dict(n_samples=1024, n_iters=12)
#: each example's ``run`` sizes: a section's name to its keyword arguments
REDUCED = {
    "quickstart": dict(
        linear=_SMALL, logistic=dict(n_iters=12),
        decision_tree=dict(n_samples=2000, max_depth=3),
        kmeans=dict(n_samples=2000, k=4), host_reduce=dict(n_iters=6),
        fused_sweep=dict(n_iters=6), mixed_queue=dict(n_iters=6)),
    "pim_ml_sklearn": dict(
        regression=dict(n_samples=512, n_iters=12),
        classification=dict(n_samples=512, n_iters=12),
        legacy_tree=dict(n_samples=2000, max_depth=3),
        legacy_kmeans=dict(n_samples=1000, max_iter=8),
        sweep=dict(n_iters=12)),
    "compare_systems": dict(pim=_SMALL, host=_SMALL, gpu_model=_SMALL,
                            fused=dict(_SMALL, fuse_steps=4)),
    "emb_recsys": dict(
        stream=dict(n_samples=1024, n_users=64, n_items=48),
        **{s: dict(n_iters=16) for s in ("eager_vs_deferred", "identity",
                                         "compressed", "registry")}),
}


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("name", list(REDUCED))
def test_reduced_example_prints_every_line_of_the_reference(name, capsys):
    importlib.import_module(f"repro_torch.examples.{name}").run(
        DEV, **REDUCED[name])
    assert skeleton(capsys.readouterr().out) == skeleton(expected(name))


@pytest.mark.parametrize("name", list(REDUCED))
def test_run_refuses_a_section_it_does_not_have(name, capsys):
    module = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(TypeError, match="no section"):
        module.run(DEV, **dict(REDUCED[name], nonesuch={}))
    assert capsys.readouterr().out == ""


def test_train_lm_loss_falls_to_the_references_floor(tmp_path, capsys):
    losses = train_lm.main(["--device", DEV, "--steps", "2", "--batch", "2",
                            "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and losses[-1] < losses[0]
    floor = re.search(r"corpus entropy floor ([\d.]+)",
                      capsys.readouterr().out).group(1)
    assert floor == f"{JMarkovCorpus(8192, seed=0).entropy_bound():.3f}"


def test_compare_applies_the_rules_and_nothing_else():
    want = expected("compare_systems")
    # the port's own CPU lines: the modeled GPU's counts and the fused line
    got = want.replace("1.36 ms / 0.54 J", "1.21 ms / 0.49 J").replace(
        "roofline 0.05 ms", "roofline 0.25 ms").replace(
        "R^2=0.6305  roofline", "R^2=0.6306  roofline")
    assert compare(got, want) == []
    for wrong in (want.replace("200 launches x", "199 launches x"),
                  want.replace("R^2=0.6305  roofline", "R^2=0.6307  roofline"),
                  want.replace("roofline 0.05 ms", "roofline 0.35 ms"),
                  want.replace("(kernel + rank legs)", "(kernel)"),
                  want + "one more line\n"):
        assert compare(wrong, want) != []
    assert all(rule.reason for rule in RULES)
    got = expected("pim_ml_sklearn").replace("'kernel_backend': None, ", "")
    assert compare(got, expected("pim_ml_sklearn")) == []
    assert mask("in 2.15s (111.7 tok/s on CUDA)") == \
        "in <wall>s (<wall> tok/s on <device>)"


def test_examples_import_neither_jax_nor_the_reference():
    code = ("import importlib, sys\n"
            f"for name in {NAMES!r} + ('outputs',):\n"
            "    importlib.import_module('repro_torch.examples.' + name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True, env=env).stdout
    assert out.strip() == "[]"
    assert sorted(m.name for m in pkgutil.iter_modules(examples.__path__)) \
        == sorted(NAMES + ("outputs",))


@pytest.mark.parametrize("name", NAMES)
def test_main_runs_on_cuda_unless_told_otherwise(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: main() would run on it")
    module = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        module.main([])
