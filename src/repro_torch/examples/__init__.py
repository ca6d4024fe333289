"""The port's counterparts of the reference's ``examples/*.py``.

One module a walkthrough, under the reference's name, each printing the
reference's lines in its format:

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``quickstart``, ``pim_ml_sklearn``, ``compare_systems``, ``emb_recsys``,
``job_queue`` and ``elastic_jobs`` walk the PIM-ML session API;
``serve_lm`` and ``train_lm`` the LM stack.  Every module runs on
``"cuda"`` unless given ``--device cpu``, and raises without a GPU; no
example carries on on the CPU in the card's place.  Each splits into
section functions whose sizes and iteration counts are keyword arguments
with the reference's values as defaults; ``main`` runs them at those.
``quickstart``, ``pim_ml_sklearn``, ``compare_systems`` and ``emb_recsys``
hold their banner and section order in ``run(device, **sizes)``, which
``main`` calls at the reference's sizes and tests at smaller ones.
``expected/<name>.txt`` holds the reference's own output, masked by
:func:`repro_torch.examples.outputs.mask`, which
:func:`repro_torch.examples.outputs.compare` holds a run against.
"""
from __future__ import annotations

import argparse

from ..systems.base import resolve_device

#: the devices an example runs on; ``"cuda"`` is the default
DEVICES = ("cuda", "cpu")


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' ``--device``."""
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=DEVICES,
                    help="where every system, estimator and model runs "
                         "(default cuda; raises without a GPU)")
    return ap


def sections(sizes: dict, *names: str) -> list:
    """The keyword arguments of each section in ``names``, from ``sizes``
    (a section's name to its sizes; ``{}``, the reference's sizes, where
    absent).  A name in ``sizes`` that is no section raises."""
    unknown = sorted(set(sizes) - set(names))
    if unknown:
        raise TypeError(f"no section {unknown}; the sections are {names}")
    return [sizes.get(name, {}) for name in names]


def parse(ap: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse ``argv``; a ``cuda`` device without a GPU raises here, before
    any work."""
    args = ap.parse_args(argv)
    resolve_device(args.device)
    return args
