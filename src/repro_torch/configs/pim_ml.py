"""The paper's own workload configs (LIN/LOG/DTR/KME on the PIM system).

A copy of ``repro.configs.pim_ml``.  These are not LM architectures;
they parameterize core/{linreg,logreg,dtree,kmeans} with the paper's
Table 3 dataset sizes (strong scaling, weak scaling per core, quality)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PimWorkloadConfig:
    workload: str          # lin | log | dtr | kme
    versions: tuple
    n_features: int = 16
    strong_scaling_samples: int = 6_291_456
    weak_scaling_per_core: int = 2_048
    quality_samples: int = 8_192


LIN = PimWorkloadConfig("lin", ("fp32", "int32", "hyb", "bui"))
LOG = PimWorkloadConfig(
    "log", ("fp32", "int32", "int32_lut_mram", "int32_lut_wram",
            "hyb_lut", "bui_lut"))
DTR = PimWorkloadConfig("dtr", ("fp32",),
                        strong_scaling_samples=153_600_000,
                        weak_scaling_per_core=600_000,
                        quality_samples=600_000)
KME = PimWorkloadConfig("kme", ("int16",),
                        strong_scaling_samples=25_600_000,
                        weak_scaling_per_core=100_000,
                        quality_samples=100_000)
ALL = {"lin": LIN, "log": LOG, "dtr": DTR, "kme": KME}
