"""Configuration dataclasses: the fields of the reference's config that the
SalientGrads slice reads, with the reference's defaults (the canonical ABCD
run: 3DCNN, 21 site-clients, batch 16, 200 rounds, SGD lr 0.01 decayed
0.998 per round, weight decay 5e-4, momentum 0.9, global-norm clip 10,
dense ratio 0.5).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class OptimConfig:
    """Local SGD: lr * lr_decay**round, clip -> wd -> momentum -> update."""

    client_optimizer: str = "sgd"
    lr: float = 0.01
    lr_decay: float = 0.998
    wd: float = 5e-4
    momentum: float = 0.9
    batch_size: int = 16
    epochs: int = 2
    grad_clip: float = 10.0
    # the fused CUDA step (ops/fused_update.py: the global norm, then one
    # pass over every leaf) instead of the stage-by-stage chain
    fused_update: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Dataset + partitioning (the synthetic ABCD cohort, site clients)."""

    dataset: str = "synthetic"
    partition_method: str = "site"
    synthetic_num_subjects: int = 256
    synthetic_shape: tuple[int, int, int] = (121, 145, 121)
    synthetic_signal: float = 12.0
    seed_split: int = 42


@dataclass(frozen=True)
class SparsityConfig:
    """SalientGrads: global SNIP mask keeping ``dense_ratio`` of the kernels."""

    dense_ratio: float = 0.5
    snip_mask: bool = True
    itersnip_iterations: int = 1


@dataclass(frozen=True)
class FedConfig:
    """Federation schedule."""

    client_num_in_total: int = 21
    frac: float = 1.0
    comm_round: int = 200
    frequency_of_the_test: int = 1

    @property
    def client_num_per_round(self) -> int:
        return max(1, int(self.client_num_in_total * self.frac))


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level experiment config."""

    model: str = "3DCNN"
    num_classes: int = 1
    algorithm: str = "salientgrads"
    seed: int = 1024
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    fed: FedConfig = field(default_factory=FedConfig)
    sparsity: SparsityConfig = field(default_factory=SparsityConfig)
