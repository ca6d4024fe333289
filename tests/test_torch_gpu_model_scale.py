"""The ``gpu-model`` target at ``examples/compare_systems.py``'s size:
LIN fp32 at 8192 x 16 over 200 iterations, serially and at
``fuse_steps=32`` (7 launches), on both packages.

* **The reference's fused fit counts 1/32 of the work.**  XLA's cost
  analysis (``src/repro/systems/gpu_model.py::_analyze``) counts a
  ``lax.scan`` body once, not once per step, so each fused chunk is
  priced as one step: the fused fit's FLOPs are its serial FLOPs x
  7/200 (a reference-side fault; ROADMAP queue 3).  The scan's loop
  counter adds a few flops a chunk, within ``SCAN_RTOL``.  The port counts
  every step of a chunk: its fused FLOPs are its serial FLOPs.
* **The port's serial bytes are 0.59 of XLA's.**  XLA's CPU layout
  assignment gives the gradient's dot a transposed copy of X, a loop
  fusion (``copy_bitcast_fusion``, ``f32[16, 8192]`` from parameter 0)
  that reads X and writes X^T before the dot reads it: 2 n f 4 B a step
  that the port's ``bmm`` over the transposed view of X does not move.
  Without that copy XLA's count is 0.95 of the port's, whose unfused
  subtract and multiply count their operands apart.  The port leaves out
  no work it runs.  ``tests/test_torch_compare.py``'s ``BYTES_BAND`` and
  ``MODELED_S_RTOL`` hold the tiny compare's sizes, where the launch
  term dominates; at this size the roofline's bytes term shows the
  ratio (modeled ms 0.89 of the reference's).
"""
import jax
import jax.experimental
import pytest

import repro.api as japi
import repro.systems.gpu_model as jgm
from repro.data.synthetic import make_linear_dataset

import repro_torch.api as tapi

N, F, ITERS, FUSE = 8192, 16, 200, 32
CHUNKS = -(-ITERS // FUSE)
#: the scan's loop counter: a few flops a chunk beyond its one step
SCAN_RTOL = 1e-3
#: the port's serial bytes over XLA's, observed (module docstring)
BYTES_RATIO = 0.5886


@pytest.fixture(scope="module")
def fits():
    """Serial and fused ``gpu-model`` fits on both packages, and the
    compiled HLO of the reference's serial step."""
    X, y, _ = make_linear_dataset(N, F, seed=0)
    steps = []
    real = jgm.ModeledGpuSystem._analyze

    def analyze(self, step, args):
        steps.append((step, args))
        return real(self, step, args)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        mp.setattr(jgm.ModeledGpuSystem, "_analyze", analyze)
        for fuse in (1, FUSE):
            for pkg, kw in ((japi, {}), (tapi, {"device": "cpu"})):
                system = pkg.make_system("gpu-model", **kw)
                wl = pkg.get_workload("linreg")
                wl.fit(system.put(X, y),
                       wl.spec("fp32", n_iters=ITERS, fuse_steps=fuse))
                out[pkg.__name__.split(".")[0], fuse] = system.gpu
    step, args = steps[0]
    out["hlo"] = step.lower(*args).compile().as_text()
    return out


def test_the_references_fused_fit_counts_one_step_a_chunk(fits):
    serial, fused = fits["repro", 1], fits["repro", FUSE]
    assert (serial.launches, fused.launches) == (ITERS, CHUNKS)
    assert fused.flops == pytest.approx(serial.flops * CHUNKS / ITERS,
                                        rel=SCAN_RTOL)


def test_the_ports_fused_fit_counts_every_step(fits):
    serial, fused = fits["repro_torch", 1], fits["repro_torch", FUSE]
    assert (serial.launches, fused.launches) == (ITERS, CHUNKS)
    assert fused.flops == pytest.approx(serial.flops, rel=0.01)
    assert serial.flops == pytest.approx(fits["repro", 1].flops, rel=1e-4)


def test_the_ports_serial_bytes_leave_out_xlas_transposed_copy(fits):
    port, ref = fits["repro_torch", 1], fits["repro", 1]
    assert port.hbm_bytes / ref.hbm_bytes == pytest.approx(BYTES_RATIO,
                                                           abs=5e-4)
    # the copy: a fusion of parameter 0 (X) into f32[F, N]
    assert f"copy_bitcast_fusion = f32[{F},{N}]" in fits["hlo"]
    copy = 2 * N * F * 4 * ITERS
    assert 0.9 <= (ref.hbm_bytes - copy) / port.hbm_bytes <= 1.0
    assert port.modeled_seconds / ref.modeled_seconds == pytest.approx(
        0.89, abs=0.01)
