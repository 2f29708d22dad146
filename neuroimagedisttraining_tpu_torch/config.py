"""Configuration dataclasses: the fields of the reference's config that the
ported engines read, with the reference's defaults (the canonical ABCD
run: 3DCNN, 21 site-clients, batch 16, 200 rounds, SGD lr 0.01 decayed
0.998 per round, weight decay 5e-4, momentum 0.9, global-norm clip 10,
dense ratio 0.5; Ditto's lamda 0.5 and 1 personal epoch; Sub-FedAvg's
prune ratio 0.1 with its accept thresholds; DisPFL's ERK masks, cosine
anneal 0.5 and random neighbours; FedFomo's 5 requested models;
TurboAggregate's 3 additive shares at 16 fraction bits on the device; no
defense, fault, DP, wire codec or secure quantized aggregation).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class OptimConfig:
    """The local optimizer at lr * lr_decay**round: SGD (clip -> wd ->
    momentum -> update) or Adam (clip -> Adam -> wd -> update)."""

    client_optimizer: str = "sgd"  # "sgd" | "adam"
    lr: float = 0.01
    lr_decay: float = 0.998
    wd: float = 5e-4
    momentum: float = 0.9
    batch_size: int = 16
    epochs: int = 2
    grad_clip: float = 10.0
    # "shuffle": walk a fresh per-epoch permutation in batch_size strides
    # (the reference DataLoader); "replacement": i.i.d. uniform draws
    batch_order: str = "shuffle"
    # the fused CUDA step (ops/fused_update.py: the global norm, then one
    # pass over every leaf) instead of the stage-by-stage chain
    fused_update: bool = False
    # the training step's compute dtype: "fp32" or "bf16_mixed" (bfloat16
    # convolutions, dense layers and activations; float32 master weights,
    # optimizer state, loss and everything outside the step), and the fixed
    # loss scale (1 = none; another value only under bf16_mixed)
    precision: str = "fp32"
    loss_scale: float = 1.0


@dataclass(frozen=True)
class DataConfig:
    """Dataset + partitioning: the ABCD cohort in the reference's
    ``X``/``y``/``site`` HDF5 file at ``data_dir`` (``abcd`` /
    ``abcd_h5``) or the synthetic cohort (``synthetic``), site clients or
    ``rescale`` / ``dir`` / ``hetero`` / ``homo``; the vision datasets
    (``cifar10``, ``cifar100``, ``tiny`` at ``data_dir``, the
    ``synthetic_vision`` cohort), partitioned ``n_cls`` / ``dir`` /
    ``my_part`` / ``homo`` / ``hetero`` (``site`` means ``dir`` there).
    ``partition_alpha``: the Dirichlet concentration (``dir``,
    ``hetero``), the classes a client (``n_cls``) or the shard groups
    (``my_part``)."""

    dataset: str = "abcd"
    data_dir: str = "./data"
    partition_method: str = "site"
    partition_alpha: float = 0.3
    synthetic_num_subjects: int = 256
    synthetic_shape: tuple[int, int, int] = (121, 145, 121)
    synthetic_signal: float = 12.0
    seed_split: int = 42
    # > 0 carves a validation split of each client's training rows
    # (FedFomo needs one)
    val_fraction: float = 0.0


@dataclass(frozen=True)
class SparsityConfig:
    """The sparse engines: SalientGrads' global SNIP mask keeping
    ``dense_ratio`` of the kernels, DisPFL's evolving per-client masks and
    Sub-FedAvg's iterative magnitude pruning."""

    dense_ratio: float = 0.5
    # DisPFL: cosine-annealed fire fraction, ERK exponent, uniform layer
    # sparsity instead of ERK, no mask evolution, random regrow instead of
    # by gradient, distinct initial masks per client, per-client densities
    # cycling 0.2..1.0
    anneal_factor: float = 0.5
    erk_power_scale: float = 1.0
    uniform: bool = False
    static: bool = False
    dis_gradient_check: bool = False
    different_initial: bool = False
    diff_spa: bool = False
    snip_mask: bool = True
    itersnip_iterations: int = 1
    # label-balanced IterSNIP batches instead of uniform ones
    stratified_sampling: bool = False
    # Sub-FedAvg: the alive fraction pruned per candidate, and the accept
    # test's thresholds on mask distance and training accuracy
    each_prune_ratio: float = 0.1
    dist_thresh: float = 0.001
    acc_thresh: float = 0.5
    # DisPFL: the final per-client masks in stat_info["final_masks"]
    save_masks: bool = False


@dataclass(frozen=True)
class FedConfig:
    """Federation schedule."""

    client_num_in_total: int = 21
    frac: float = 1.0
    comm_round: int = 200
    # DisPFL's neighbour choice (random | ring | full | self) and each
    # client's Bernoulli activity a round
    cs: str = "random"
    neighbor_num: int = 5          # gossip fan-out when cs == "random"
    active: float = 1.0
    frequency_of_the_test: int = 1
    # CI mode: every evaluation takes client 0 only
    ci: bool = False
    # Ditto's proximal weight (also FedProx's mu) and personal epochs
    lamda: float = 0.5
    local_epochs: int = 1
    # FedFomo: models a client requests a round
    fomo_m: int = 5
    # TurboAggregate: additive shares a client update, fixed-point fraction
    # bits in GF(p), and where the share stage runs ("device" | "host")
    mpc_n_shares: int = 3
    mpc_frac_bits: int = 16
    mpc_backend: str = "device"
    # secure quantized aggregation (privacy/secure_quant.py): the round's
    # tail becomes the GF(p) fold of field-element frames, p the largest
    # prime below 2^field_bits, at frac_bits fixed-point bits; an
    # in-process cohort of 2 or more needs field_bits 32
    secure_quant: bool = False
    secure_quant_field_bits: int = 16
    secure_quant_frac_bits: int = 10
    # the defended round (core/robust.py): none | norm_diff_clipping |
    # weak_dp | trimmed_mean | median | krum | multi_krum |
    # geometric_median; the clip bound and weak-DP noise; the assumed
    # Byzantine count f (trim depth a side, Krum's neighbourhood: the
    # cohort needs n >= f + 3 for Krum, 2f < n for the coordinate-wise
    # defenses); the geometric median's Weiszfeld steps
    defense_type: str = "none"
    norm_bound: float = 5.0
    stddev: float = 0.05
    byz_f: int = 1
    geomed_iters: int = 8
    # D-PSGD's round-level DP: each client's update against its consensus
    # point clipped to dp_clip and noised with N(0, (dp_sigma * dp_clip)^2);
    # 0 is off, dp_sigma > 0 needs dp_clip > 0; the accountant's delta
    dp_clip: float = 0.0
    dp_sigma: float = 0.0
    dp_delta: float = 1e-5
    # the seeded fault schedule (faults/schedule.py): crashes, Byzantine
    # value faults and the comm-level draws
    fault_spec: str = ""
    # the wire codec's stages (codec/wire.py) and the top-k keep fraction
    wire_codec: str = "none"
    wire_topk_ratio: float = 0.25
    # up to K rounds a window (engines/program.py): their host reads wait
    # for the window's end, hooks (evaluation, the last round, an engine's
    # extra hook) land on a window's last round, and on a card the local
    # steps replay CUDA graphs; engines that cross the host each round run
    # one round at a time, with a logged reason
    rounds_per_dispatch: int = 1
    # split the sampled clients of a round over a client mesh of exactly
    # this many entries (parallel/cohort.py); 0: unsharded
    client_mesh: int = 0

    @property
    def client_num_per_round(self) -> int:
        return max(1, int(self.client_num_in_total * self.frac))


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level experiment config."""

    model: str = "3DCNN"
    # 1: one logit and BCE (ABCD); more: softmax cross-entropy
    num_classes: int = 1
    algorithm: str = "fedavg"
    seed: int = 1024
    # LOG/<dataset>/<identity>.log and .metrics.jsonl go here; None writes
    # no experiment log
    log_dir: str | None = None
    # clients a streamed chunk holds (--streaming); 0 picks 4
    stream_chunk_clients: int = 0
    # the AlexNet family's rematerialisation: auto | none | stem | all
    # (core/optim.py resolve_remat)
    remat: str = "auto"
    # the device mesh (parallel/mesh.py): () => every visible device on
    # one "clients" axis; one value: the first N; two (silos, clients):
    # the two-level mesh of silo-first aggregation
    mesh_shape: tuple[int, ...] = ()
    # a mesh of N entries on the run's device (N > 0), as the reference
    # provisions N virtual CPU devices; 0: the visible devices
    virtual_devices: int = 0
    # the last part of the experiment's identity (its log file name)
    tag: str = "exp"
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    fed: FedConfig = field(default_factory=FedConfig)
    sparsity: SparsityConfig = field(default_factory=SparsityConfig)

    def identity(self) -> str:
        """The experiment's identity string (the reference's log file name,
        ending in its ``tag``)."""
        d, o, f, s = self.data, self.optim, self.fed, self.sparsity
        parts = [
            self.algorithm, d.dataset, self.model,
            f"c{f.client_num_in_total}", f"frac{f.frac}", f"r{f.comm_round}",
            f"e{o.epochs}", f"b{o.batch_size}", f"lr{o.lr}", f"dec{o.lr_decay}",
            f"wd{o.wd}", f"part-{d.partition_method}{d.partition_alpha}",
            f"dr{s.dense_ratio}", f"seed{self.seed}", self.tag,
        ]
        return "_".join(str(p) for p in parts)
