"""End-to-end LM training launcher (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 5 --batch 2 --seq 64 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --full --layers 8 \\
      --batch 8 --seq 1024 --steps 5

``--arch`` takes every config.  ``--device cuda`` (the default) trains on
the card, attention forward and backward (windows and cross-attention
included) in the ``flash_attention`` kernels, and raises without a GPU;
``--device cpu`` runs their plain versions.  Weights are random, drawn from
``train``'s ``seed`` on the device; batches come from
``MarkovCorpus(vocab, seed)``, the VLM's vision states and the audio
family's frames beside them as the reference draws them
(:func:`draw_batch`).  A run resumed from ``--ckpt-dir`` restores
``(params, opt_state)`` through ``train/checkpoint.py`` and draws (and
drops) the batches of the steps it skips, so its later steps see the
batches an uninterrupted run would.  The reference restarts the corpus
instead, so its resumed steps see the first batches again.

The PIM-ML workloads launch through ``python -m repro_torch.launch.pim_ml``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_config
from repro_torch.data.tokens import MarkovCorpus
from repro_torch.models.api import Model
from repro_torch.optim.adam import AdamState, AdamW
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault_tolerance import StragglerMonitor
from repro_torch.train.loop import make_train_step


def build(arch: str, *, reduced: bool, lr: float = 3e-4,
          microbatches: int = 1, quantize_dense: bool = False,
          lut_activations: bool = False, overrides: Optional[dict] = None,
          device="cuda"):
    """``(cfg, model, opt, step_fn)``.  ``overrides`` apply to the reduced
    config, or to the full one when ``reduced`` is False (``--layers``)."""
    cfg = get_config(arch)
    cfg = (cfg.reduced(**(overrides or {})) if reduced
           else dataclasses.replace(cfg, **(overrides or {})))
    if quantize_dense or lut_activations:
        cfg = dataclasses.replace(cfg, quantize_dense=quantize_dense,
                                  lut_activations=lut_activations)
    model = Model(cfg, device=device)
    opt = AdamW(lr=lr)
    step_fn = make_train_step(model, opt, microbatches=microbatches)
    return cfg, model, opt, step_fn


def checkpoint_state(params, opt_state: AdamState) -> tuple:
    """``(params, opt_state)`` as a tree ``train/checkpoint.py`` saves."""
    return (dict(params.named_parameters()),
            (opt_state.step, opt_state.m, opt_state.v))


def restore_state(ckpt_dir: str, step: int, params,
                  opt_state: AdamState) -> tuple:
    """Load checkpoint ``step`` into ``params`` (in place) and a new
    optimizer state: ``(params, opt_state)``."""
    named, (st, m, v) = ckpt_lib.restore(
        ckpt_dir, step, checkpoint_state(params, opt_state))
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(named[name])
    return params, AdamState(step=st, m=m, v=v)


def draw_batch(cfg: ArchConfig, corpus: MarkovCorpus, batch: int, seq: int,
               step: int) -> dict:
    """Step ``step``'s batch: the corpus's next tokens and targets, and for
    the VLM ``vision`` [batch, vision_tokens, vision_dim], for the audio
    family ``frames`` [batch, encoder_seq, d_model]: float32 N(0, 1) drawn
    from ``RandomState(step)``, as the reference's launcher draws them."""
    out = corpus.batch(batch, seq)
    extra = {"vlm": ("vision", (cfg.vision_tokens, cfg.vision_dim)),
             "audio": ("frames", (cfg.encoder_seq, cfg.d_model))}
    if cfg.family in extra:
        name, shape = extra[cfg.family]
        out[name] = np.random.RandomState(step).normal(
            0, 1, (batch, *shape)).astype(np.float32)
    return out


def train(arch: str, *, steps: int, batch: int, seq: int,
          reduced: bool = True, ckpt_dir: str = "", ckpt_every: int = 50,
          lr: float = 3e-4, seed: int = 0, microbatches: int = 1,
          log_every: int = 10, resume: bool = True,
          quantize_dense: bool = False, lut_activations: bool = False,
          overrides: Optional[dict] = None, device="cuda"):
    """Train ``steps`` steps: ``(params, losses, corpus)``."""
    cfg, model, opt, step_fn = build(
        arch, reduced=reduced, lr=lr, microbatches=microbatches,
        quantize_dense=quantize_dense, lut_activations=lut_activations,
        overrides=overrides, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = model.init(gen).trainable_()
    opt_state = opt.init(params)
    corpus = MarkovCorpus(cfg.vocab_size, seed=seed)
    start = 0
    if ckpt_dir and resume:
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is not None:
            params, opt_state = restore_state(ckpt_dir, last, params,
                                              opt_state)
            start = last
            for _ in range(start):
                corpus.batch(batch, seq)
            print(f"resumed from step {last}")

    monitor = StragglerMonitor()
    losses = []
    t_start = time.perf_counter()
    for step in range(start, steps):
        batch_np = draw_batch(cfg, corpus, batch, seq, step)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch_np)
        loss = float(metrics["loss"])          # waits for the step
        monitor.observe(time.perf_counter() - t0)
        losses.append(loss)
        if (step + 1) % log_every == 0 or step == start:
            tput = batch * seq * log_every / max(
                time.perf_counter() - t_start, 1e-9)
            t_start = time.perf_counter()
            print(f"step {step + 1:5d}  loss {loss:7.4f}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  "
                  f"~{tput_fmt(tput)} tok/s")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt_lib.save(ckpt_dir, step + 1,
                          checkpoint_state(params, opt_state))
    return params, losses, corpus


def tput_fmt(x: float) -> str:
    return f"{x/1e3:.1f}k" if x > 1e3 else f"{x:.0f}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers: the CLI spelling of "
                         "train(overrides={'n_layers': N}), on the full "
                         "config with --full")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--quantize-dense", action="store_true",
                    help="paper technique: int8 linear layers")
    ap.add_argument("--lut-activations", action="store_true",
                    help="paper technique: LUT activations")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    _, losses, _ = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        reduced=args.reduced, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, lr=args.lr,
        microbatches=args.microbatches,
        quantize_dense=args.quantize_dense,
        lut_activations=args.lut_activations,
        overrides={"n_layers": args.layers} if args.layers else None,
        device=args.device)
    print(f"trained {len(losses)} steps in {time.perf_counter() - t0:.2f} s "
          f"on {args.device}: losses {losses}")


if __name__ == "__main__":
    main()
