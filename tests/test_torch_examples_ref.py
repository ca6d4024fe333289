"""The oracle of the port's examples: the JAX package's own walkthroughs.

Each reference example (``examples/<name>.py``) runs whole, in process,
at its own sizes, its stdout captured; masked by
``repro_torch.examples.outputs.mask`` it must equal
``src/repro_torch/examples/expected/<name>.txt`` exactly.  So the files
the port's examples are held to (``tests/test_torch_examples.py``, and
on the card ``chip_smoke.py`` phase 19) are what the reference prints.

The reference's ``mul_round_f32`` calls ``jax.experimental.enable_x64``,
which this JAX no longer has; :func:`x64_alias` aliases it for this
file's tests only.  ``tests/test_torch_examples_ref_lm.py`` runs the
other examples, so that the two files share the run's workers.
"""
import contextlib
import io
import runpy
from pathlib import Path

import jax
import jax.experimental
import pytest

from repro_torch.examples.outputs import expected, mask

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


def reference_output(name: str) -> str:
    """What ``examples/<name>.py`` prints, run as a script."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return buf.getvalue()


@pytest.mark.parametrize("name", ["quickstart", "compare_systems",
                                  "job_queue", "elastic_jobs"])
def test_reference_example_prints_its_expected_file(name):
    assert mask(reference_output(name)) == expected(name)
