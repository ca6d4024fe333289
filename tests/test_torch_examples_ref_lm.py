"""The oracle of the port's examples, continued: ``emb_recsys``,
``pim_ml_sklearn`` and ``serve_lm`` run whole as the JAX package's own
scripts, their masked stdout equal to
``src/repro_torch/examples/expected/<name>.txt`` exactly (see
``tests/test_torch_examples_ref.py``, which runs the other four; the
split keeps each file's share of a worker under a minute).
"""
import pytest

from test_torch_examples_ref import reference_output, x64_alias  # noqa: F401

from repro_torch.examples.outputs import expected, mask


@pytest.mark.parametrize("name", ["emb_recsys", "pim_ml_sklearn",
                                  "serve_lm"])
def test_reference_example_prints_its_expected_file(name):
    assert mask(reference_output(name)) == expected(name)
