"""The reference examples' printed output, and a run held against it.

``expected/<name>.txt`` is what the JAX package's ``examples/<name>.py``
prints at its own sizes, passed through :func:`mask`.  :func:`compare`
holds a port example's output to it line by line: the text between the
numbers must be equal, and each number exact unless a rule of
:data:`RULES` says otherwise.  Every rule gives its reason.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Optional

EXPECTED = Path(__file__).resolve().parent / "expected"

#: what no run can repeat: wall-clock figures, temp paths, the device word
_MASKS = (
    (re.compile(r"measured \d+\.\d+ ms"), "measured <wall> ms"),
    (re.compile(r"\(\d+\.\d+s wall\)"), "(<wall>s wall)"),
    (re.compile(r"in \d+\.\d+s"), "in <wall>s"),
    (re.compile(r"\d+\.\d+ tok/s on \w+\)"), "<wall> tok/s on <device>)"),
    (re.compile(r"(?<![\w.])/(?:[\w.-]+/)+[\w.-]+"), "<path>"),
)

#: a printed number: optional sign, digits (or thousands grouped by
#: commas), optional fraction and exponent
NUMBER = re.compile(r"-?(?:\d{1,3}(?:,\d{3})+|\d+)(?:\.\d+)?(?:e[-+]\d+)?")


@dataclasses.dataclass(frozen=True)
class Rule:
    """A difference from the reference that is not a port fault.

    The rule applies to the reference's lines that ``line`` matches, and
    to the numbers inside a match of ``at`` there.  A number is held to
    ``units`` units of its last printed digit, or to a ratio got / want
    within ``ratio``.  ``drop`` is text removed from the reference's line
    before it is compared."""

    line: str
    reason: str
    at: str = ""
    units: Optional[float] = None
    ratio: Optional[tuple] = None
    drop: str = ""


#: fp32 arithmetic in another order: one unit of the last printed digit,
#: on the CPU (torch's CPU kernels against XLA's) and on the card (on an
#: NVIDIA H100 80GB HBM3 at 700 W every such figure of the six PIM-ML
#: examples printed equal to the reference's: chip_smoke.py phase 19)
FP32_REASON = ("float32 arithmetic in another order (torch against XLA, "
               "and the card's kernels against the CPU's)")

RULES = (
    Rule(r"CPU float32|PIM fp32 ", FP32_REASON, at=r"[\d.]+% err", units=1),
    Rule(r"adjusted Rand index", FP32_REASON
         + ": the ARI against the fp32 host k-means",
         at=r"= [\d.]+", units=1),
    Rule(r"get_params", "the reference's "
         "kernel_backend hyperparameter has no counterpart in the port: the "
         "kernel is chosen by the tensor's device",
         drop=r"'kernel_backend': None, "),
    Rule(r"on HostSystem", FP32_REASON
         + ": the fp32 R^2", at=r"R\^2 = [\d.]+", units=1),
    Rule(r"PimKMeans", FP32_REASON
         + ": the inertia is a float32 sum", at=r"inertia = \S+", units=1),
    Rule(r"^(host|gpu-model) +fp32 ", FP32_REASON
         + ": the fp32 R^2", at=r"R\^2=[\d.]+", units=1),
    Rule(r"^gpu-model fp32   R", "the port counts "
         "each op's operands and result (TorchDispatchMode), XLA's cost "
         "analysis its fused HLO: at 8192 x 16 the port's bytes a step "
         "are 0.59 of XLA's, so its modeled ms and J 0.89 of the "
         "reference's (tests/test_torch_gpu_model_scale.py)",
         at=r"roofline [\d.]+ ms / [\d.]+ J", ratio=(0.87, 0.91)),
    Rule(r"fuse_steps=", "the reference's fault: XLA's "
         "cost analysis counts a scanned chunk's body once, so its fused "
         "fit prints 7/200 of the serial work; the port counts every step "
         "(tests/test_torch_gpu_model_scale.py)",
         at=r"roofline [\d.]+ ms", ratio=(4.5, 5.5)),
    Rule(r"emb/fp32", FP32_REASON + ": the fp32 R^2",
         at=r"R\^2 = [\d.]+", units=1),
)


def mask(text: str) -> str:
    """``text`` with what no run can repeat blanked."""
    for pattern, repl in _MASKS:
        text = pattern.sub(repl, text)
    return text


def expected(name: str) -> str:
    """The reference's masked output of example ``name``."""
    return (EXPECTED / f"{name}.txt").read_text()


def _rules(line: str) -> list:
    return [r for r in RULES if re.search(r.line, line)]


def _unit(text: str) -> float:
    """One unit of the last printed digit of number ``text``."""
    mant, _, exp = text.replace(",", "").partition("e")
    decimals = len(mant.partition(".")[2])
    return 10.0 ** (int(exp or 0) - decimals)


def _value(text: str) -> float:
    return float(text.replace(",", ""))


def _split(line: str) -> tuple:
    """(the text between the numbers, [(number, span)])."""
    nums = [(m.group(), m.span()) for m in NUMBER.finditer(line)]
    return NUMBER.split(line), nums


def skeleton(text: str) -> list:
    """``text``'s lines with every number as ``#`` and runs of spaces as
    one, the rules' ``drop`` text removed: a run at other sizes prints
    this skeleton."""
    out = []
    for line in mask(text).splitlines():
        for rule in _rules(line):
            if rule.drop:
                line = re.sub(rule.drop, "", line)
        out.append(re.sub(r" +", " ", NUMBER.sub("#", line)))
    return out


def compare(got: str, want: str) -> list:
    """The differences of ``got`` (a run's raw output) from ``want`` (the
    masked reference output) that no rule allows; ``[]`` when none."""
    got_lines, want_lines = mask(got).splitlines(), mask(want).splitlines()
    if len(got_lines) != len(want_lines):
        return [f"{len(got_lines)} lines, the reference {len(want_lines)}"]
    faults = []
    for i, (g, w) in enumerate(zip(got_lines, want_lines), 1):
        rules = _rules(w)
        for rule in rules:
            if rule.drop:
                w = re.sub(rule.drop, "", w)
        (g_text, g_nums), (w_text, w_nums) = _split(g), _split(w)
        if g_text != w_text or len(g_nums) != len(w_nums):
            faults.append(f"line {i}: {g!r} != {w!r}")
            continue
        spans = [(rule, m.span()) for rule in rules if rule.at
                 for m in re.finditer(rule.at, w)]
        for (gn, _), (wn, (a, b)) in zip(g_nums, w_nums):
            rule = next((r for r, (lo, hi) in spans if lo <= a and b <= hi),
                        None)
            if rule is None:
                ok = gn == wn
            elif rule.ratio is not None:
                lo, hi = rule.ratio
                ok = lo <= _value(gn) / _value(wn) <= hi
            else:
                ok = abs(_value(gn) - _value(wn)) <= rule.units * _unit(wn) * (
                    1 + 1e-9)
            if not ok:
                faults.append(f"line {i}: {gn} != {wn} in {w!r}")
    return faults
