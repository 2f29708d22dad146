"""CLI of the port:

    python -m neuroimagedisttraining_tpu_torch \\
        --algorithm fedavg|fedprox|salientgrads|ditto|local|subavg|dispfl|\\
                    dpsgd|fedfomo|turboaggregate \\
        --dataset abcd_h5 --data_dir cohort.h5 [--streaming \\
        --stream_chunk_clients N] | --dataset synthetic \\
        --synthetic_shape 121 145 121 | --dataset cifar10|cifar100|tiny \\
        --data_dir DIR | --dataset synthetic_vision \\
        [--partition_method site|dir|n_cls|my_part|homo|hetero|rescale \\
        --partition_alpha A] \\
        --model 3DCNN|3DCNN_gn|3DCNN_deeper|3DCNN_regression|3DCNN_tiny|\\
                resnet3d|resnet18|vgg11|cnn_cifar10|resnet_meta|darts|\\
                fednas_v1|darts_search|... \\
        [--num_classes K] [--fused_update] \\
        [--client_optimizer sgd|adam] [--precision fp32|bf16_mixed \\
        [--loss_scale S]] [--remat auto|none|stem|all] \\
        [--val_fraction F] [--device cuda|cpu] [--log_dir LOG] \\
        [--tag TAG] [--ci 1] [--no_snip_mask] \\
        [--fault_spec SPEC] [--defense_type NAME --norm_bound B \\
        --stddev S --byz_f F --geomed_iters N] [--dp_clip C \\
        --dp_sigma Z --dp_delta D] [--wire_codec STAGES \\
        --wire_topk_ratio R] [--secure_quant --secure_quant_field_bits \\
        8|16|32 --secure_quant_frac_bits F] [--rounds_per_dispatch K] \\
        [--client_mesh N] [--mesh_shape S [C]] [--virtual_devices N] \\
        [--cs random|ring|full --neighbor_num K] ...

Flag names are the reference CLI's for the flags the port takes.
``--dataset ABCD`` / ``abcd_h5`` (the default) reads the X/y/site HDF5 file
at ``--data_dir``, ``synthetic`` draws the synthetic cohort (both
partitioned by site, or by ``rescale`` / ``dir`` / ``hetero`` / ``homo``
into ``--client_num_in_total`` clients), ``cifar10`` / ``cifar100`` /
``tiny`` read the vision files at ``--data_dir`` and ``synthetic_vision``
draws a small image cohort (``data/vision.py``; ``n_cls`` / ``dir`` /
``my_part`` / ``homo`` / ``hetero``, ``site`` meaning ``dir``; 10, 100
or 200 classes unless ``--num_classes`` says otherwise), and any other
name raises. ``--streaming`` keeps the voxels on the host and feeds the
card a chunk of site clients at a time (``data/stream.py``; not for the
vision datasets). It logs
the rounds and prints, last, one JSON line with what the engine returns
except its model states (``mask_density`` for SalientGrads only).
``NIDT_FAST_STEM=1`` arms the stem weight-gradient kernel (float32 or
bfloat16, by ``--precision``), ``NIDT_FAST_POOL=1`` the tie-splitting max
pool. FedFomo needs ``--val_fraction > 0``; ``--fused_update`` is for the
SGD optimizer only; ``--loss_scale`` other than 1 needs ``--precision
bf16_mixed``. The fault, defense, DP, codec and secure quantization flags
are the reference's, with its defaults and refusals (TurboAggregate and
``--secure_quant`` take neither the codec nor an order-statistic defense;
``--dp_sigma`` needs ``--dp_clip``; the DP flags only D-PSGD;
``--secure_quant`` only an engine with the default aggregation tail and a
field with the headroom; the engines refuse what their round does not run,
and ``preempt:`` faults). An in-process ``--secure_quant`` cohort of 2 or
more clients needs ``--secure_quant_field_bits 32``.

``--rounds_per_dispatch K`` runs windows of up to K rounds
(``engines/program.py``: one host read a window); on a card the local
steps of every round replay CUDA graphs (``core/graphs.py``); ``--client_mesh N`` splits each round's clients over a
mesh of N entries, ``--mesh_shape S C`` aggregates silo first, and
``--virtual_devices N`` makes the mesh's N entries on the run's device
(``parallel/``). ``--neighbor_num`` is stored, as in the reference, and read
by no engine.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import torch

from neuroimagedisttraining_tpu_torch.config import (
    DataConfig, ExperimentConfig, FedConfig, OptimConfig, SparsityConfig,
)
from neuroimagedisttraining_tpu_torch.core.optim import validate_precision
from neuroimagedisttraining_tpu_torch.engines import ENGINES, create_engine


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--algorithm", type=str, default="fedavg",
                        choices=sorted(ENGINES))
    parser.add_argument("--model", type=str, default="3DCNN")
    parser.add_argument("--num_classes", type=int, default=1,
                        help="1: one logit and BCE; more: softmax CE")
    parser.add_argument("--dataset", type=str, default="ABCD",
                        help="ABCD | abcd_h5 | synthetic | cifar10 | "
                             "cifar100 | tiny | synthetic_vision")
    parser.add_argument("--data_dir", type=str, default="./data",
                        help="for ABCD/abcd_h5: path to the X/y/site HDF5")
    parser.add_argument("--partition_method", type=str, default="site",
                        help="site | dir | n_cls | my_part | homo | hetero "
                             "| rescale")
    parser.add_argument("--partition_alpha", type=float, default=0.3)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--client_optimizer", type=str, default="sgd",
                        choices=["sgd", "adam"])
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--lr_decay", type=float, default=0.998)
    parser.add_argument("--wd", type=float, default=5e-4)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--grad_clip", type=float, default=10.0)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch_order", type=str, default="shuffle",
                        choices=["shuffle", "replacement"],
                        help="per-epoch shuffled strides or i.i.d. draws")
    parser.add_argument("--client_num_in_total", type=int, default=21)
    parser.add_argument("--frac", type=float, default=1.0)
    parser.add_argument("--comm_round", type=int, default=200)
    parser.add_argument("--frequency_of_the_test", type=int, default=1)
    parser.add_argument("--ci", type=int, default=0,
                        help="nonzero: every evaluation takes client 0 "
                             "only")
    parser.add_argument("--seed", type=int, default=1024)
    parser.add_argument("--seed_split", type=int, default=42)
    parser.add_argument("--cs", type=str, default="random",
                        choices=["random", "ring", "full", "self"],
                        help="DisPFL's and D-PSGD's neighbour choice")
    parser.add_argument("--neighbor_num", type=int, default=5,
                        help="gossip fan-out when --cs random")
    parser.add_argument("--active", type=float, default=1.0,
                        help="DisPFL: each client's activity probability")
    parser.add_argument("--dense_ratio", type=float, default=0.5)
    parser.add_argument("--anneal_factor", type=float, default=0.5)
    parser.add_argument("--erk_power_scale", type=float, default=1.0)
    parser.add_argument("--no_snip_mask", action="store_true",
                        help="SalientGrads: train dense (every mask entry "
                             "1) after phase 1")
    parser.add_argument("--uniform", action="store_true")
    parser.add_argument("--static", action="store_true")
    parser.add_argument("--dis_gradient_check", action="store_true")
    parser.add_argument("--different_initial", action="store_true")
    parser.add_argument("--diff_spa", action="store_true")
    parser.add_argument("--save_masks", action="store_true")
    parser.add_argument("--each_prune_ratio", type=float, default=0.1)
    parser.add_argument("--dist_thresh", type=float, default=0.001)
    parser.add_argument("--acc_thresh", type=float, default=0.5)
    parser.add_argument("--itersnip_iteration", type=int, default=1)
    parser.add_argument("--stratified_sampling", action="store_true")
    parser.add_argument("--lamda", type=float, default=0.5)
    parser.add_argument("--local_epochs", type=int, default=1)
    parser.add_argument("--fomo_m", type=int, default=5)
    parser.add_argument("--val_fraction", type=float, default=0.0,
                        help="> 0 carves a validation split of each "
                             "client's training rows (FedFomo needs it)")
    parser.add_argument("--mpc_n_shares", type=int, default=3,
                        help="TurboAggregate: additive shares per client "
                             "update")
    parser.add_argument("--mpc_frac_bits", type=int, default=16,
                        help="TurboAggregate: fixed-point fraction bits "
                             "for GF(p) quantization")
    parser.add_argument("--mpc_backend", type=str, default="device",
                        choices=["device", "host"],
                        help="TurboAggregate's share stage: on the device "
                             "(default) or in numpy on the host")
    parser.add_argument("--secure_quant", action="store_true",
                        help="secure QUANTIZED aggregation "
                             "(privacy/secure_quant.py): the round "
                             "aggregates through the GF(p) integer-weight "
                             "fold on the device (bit for bit the host "
                             "SlotAccumulator fold), so round metrics "
                             "reflect exactly what the encoded secure "
                             "wire would deliver. Needs "
                             "--secure_quant_field_bits 32 (the one-"
                             "phase capacity bound)")
    parser.add_argument("--secure_quant_field_bits", type=int, default=16,
                        choices=(8, 16, 32),
                        help="secure_quant field width: p = largest prime "
                             "below 2^bits (the wire ships one uintN "
                             "residue per parameter)")
    parser.add_argument("--secure_quant_frac_bits", type=int, default=10,
                        help="secure_quant fixed-point fraction bits; the "
                             "aggregate range value_bound * 2^frac_bits "
                             "must stay inside p/2 (checked at startup)")
    parser.add_argument("--fault_spec", type=str, default="",
                        help="deterministic fault schedule (faults/): "
                             "'crash:RANK@ROUND,crash_prob:P,"
                             "straggle:P:MAX_S,drop:P,dup:P,disconnect:P,"
                             "byz:RANK@ROUND:KIND,byz_prob:P[:KIND]' "
                             "— crashed clients leave the sampled cohort "
                             "(survivor-reweighted rounds); byz clients "
                             "upload KIND-corrupted values (sign_flip | "
                             "scale:K | gauss:STD | nonfinite, "
                             "faults/adversary.py); client c is rank c+1")
    parser.add_argument("--wire_codec", type=str, default="none",
                        help="model-update wire codec (codec/): '+'-"
                             "joined stages from {delta, sparse, quant, "
                             "quant16}, e.g. delta+sparse+quant; the "
                             "round applies the codec's lossy transform "
                             "to client uploads before aggregation and "
                             "accounts encoded vs dense bytes in "
                             "stat_info")
    parser.add_argument("--wire_topk_ratio", type=float, default=0.25,
                        help="wire codec sparse stage for dense engines: "
                             "magnitude top-k keep fraction (per-client "
                             "error feedback re-injects dropped mass "
                             "next round); masked engines use their own "
                             "mask instead")
    parser.add_argument("--dp_clip", type=float, default=0.0,
                        help="dpsgd round-level DP: clip each client's "
                             "update delta (vs its consensus point) to "
                             "this L2 bound before it reaches any "
                             "neighbor (0 = off)")
    parser.add_argument("--dp_sigma", type=float, default=0.0,
                        help="dpsgd round-level DP: Gaussian noise "
                             "multiplier — noise stddev is dp_sigma * "
                             "dp_clip; the RDP accountant "
                             "(privacy/accountant.py) reports the running "
                             "per-silo (epsilon, dp_delta) in stat_info "
                             "(0 = off; requires --dp_clip)")
    parser.add_argument("--dp_delta", type=float, default=1e-5,
                        help="target delta for the RDP -> (epsilon, "
                             "delta) conversion (dpsgd DP and the "
                             "weak_dp defense accountant)")
    parser.add_argument("--defense_type", "--defense", dest="defense_type",
                        type=str, default="none",
                        help="none | norm_diff_clipping | weak_dp | "
                             "trimmed_mean | median | krum | multi_krum | "
                             "geometric_median — the clip family applies "
                             "per client before the weighted mean; the "
                             "order-statistic family (core/robust.py) "
                             "replaces the mean and tolerates up to "
                             "--byz_f Byzantine clients")
    parser.add_argument("--norm_bound", type=float, default=5.0)
    parser.add_argument("--stddev", type=float, default=0.05)
    parser.add_argument("--byz_f", type=int, default=1,
                        help="assumed Byzantine client count f for the "
                             "order-statistic defenses: trim depth per "
                             "side (trimmed_mean), Krum neighborhood "
                             "(sampled cohort must be >= f + 3; "
                             "trimmed_mean/median need 2f < n)")
    parser.add_argument("--geomed_iters", type=int, default=8,
                        help="geometric_median: fixed Weiszfeld "
                             "iteration count")
    parser.add_argument("--fused_update", action="store_true")
    parser.add_argument("--precision", type=str, default="fp32",
                        choices=("fp32", "bf16_mixed"),
                        help="the training step's compute dtype: fp32, or "
                             "bf16_mixed (bfloat16 convolutions, dense "
                             "layers and activations; float32 master "
                             "weights, optimizer state, loss and every "
                             "engine plane)")
    parser.add_argument("--loss_scale", type=float, default=1.0,
                        help="fixed loss scale under bf16_mixed (the loss "
                             "times S before the gradient, the float32 "
                             "gradients over S after); 1 = none")
    parser.add_argument("--remat", type=str, default="auto",
                        choices=("auto", "none", "stem", "all"),
                        help="the AlexNet family's rematerialisation: "
                             "blocks f0-f1 (stem) or all recompute their "
                             "activations in the backward pass; auto arms "
                             "stem past the card's measured batch cutoff")
    parser.add_argument("--synthetic_num_subjects", type=int, default=256)
    parser.add_argument("--synthetic_shape", type=int, nargs=3,
                        default=[121, 145, 121])
    parser.add_argument("--synthetic_signal", type=float, default=12.0)
    parser.add_argument("--log_dir", type=str, default=None,
                        help="write <log_dir>/<dataset>/<identity>.log and "
                             ".metrics.jsonl (none if unset)")
    parser.add_argument("--streaming", action="store_true",
                        help="host-stream the cohort per round instead of "
                             "keeping it device-resident (cohorts > device "
                             "memory); supported by all ten algorithms "
                             "(fedfomo additionally needs --val_fraction "
                             "> 0: its small val shards stay resident)")
    parser.add_argument("--stream_chunk_clients", type=int, default=0,
                        help="clients per host-fetched chunk in streaming "
                             "rounds, evaluation and SNIP scoring (0 = "
                             "auto)")
    parser.add_argument("--virtual_devices", type=int, default=0,
                        help="a device mesh of N entries on the run's "
                             "device (N streams of one card, or N CPU "
                             "entries): mesh simulation without N cards, "
                             "as the reference provisions N virtual CPU "
                             "devices")
    parser.add_argument("--mesh_shape", type=int, nargs="*", default=[],
                        help="device mesh layout: one value = first-N 1-D "
                             "clients mesh; two values (silos clients) = "
                             "two-level cross-silo mesh (silo-first "
                             "aggregation, parallel/hierarchical.py)")
    parser.add_argument("--client_mesh", type=int, default=0,
                        help="split the sampled clients of every round "
                             "over a client mesh of exactly N entries "
                             "(parallel/cohort.py): each entry trains its "
                             "block of clients on its own stream, the "
                             "aggregation runs on the gathered states, "
                             "bit-equal to the unsharded round; cohorts "
                             "that do not tile the mesh pad with "
                             "zero-weight rows. Engines and modes without "
                             "a sharded round (engines/program.py) run "
                             "unsharded with a logged reason. Combine "
                             "with --virtual_devices N to simulate N "
                             "entries on one device")
    parser.add_argument("--rounds_per_dispatch", type=int, default=1,
                        help="run up to K rounds as one window when the "
                             "engine's round keeps no host-side state "
                             "between rounds: sampling and lr come from "
                             "the round index, the host reads the "
                             "window's losses once at its end, and "
                             "evaluation / the last round / an engine's "
                             "extra hook land on a window's last round; "
                             "on a card each local step replays a CUDA "
                             "graph. Fused engines: fedavg/fedprox/"
                             "salientgrads/ditto/local/subavg/dpsgd; the "
                             "others run one round at a time with a "
                             "logged reason")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--tag", type=str, default="exp",
                        help="the last part of the experiment's identity "
                             "(its log file name)")
    return parser


#: the vision datasets and the class counts they imply
VISION_CLASSES = {"cifar10": 10, "synthetic_vision": 10, "cifar100": 100,
                  "tiny": 200}


def config_from_args(args) -> ExperimentConfig:
    """The experiment of parsed ``args``; ``--num_classes 1`` (the default)
    with a vision dataset means the dataset's class count."""
    num_classes = args.num_classes
    if num_classes == 1:
        num_classes = VISION_CLASSES.get(args.dataset.lower(), 1)
    return ExperimentConfig(
        model=args.model, num_classes=num_classes,
        algorithm=args.algorithm, seed=args.seed, tag=args.tag,
        log_dir=args.log_dir,
        stream_chunk_clients=args.stream_chunk_clients, remat=args.remat,
        mesh_shape=tuple(args.mesh_shape),
        virtual_devices=args.virtual_devices,
        data=DataConfig(dataset=args.dataset.lower(), data_dir=args.data_dir,
                        partition_method=args.partition_method,
                        partition_alpha=args.partition_alpha,
                        synthetic_num_subjects=args.synthetic_num_subjects,
                        synthetic_shape=tuple(args.synthetic_shape),
                        synthetic_signal=args.synthetic_signal,
                        seed_split=args.seed_split,
                        val_fraction=args.val_fraction),
        optim=OptimConfig(client_optimizer=args.client_optimizer,
                          lr=args.lr, lr_decay=args.lr_decay, wd=args.wd,
                          momentum=args.momentum, batch_size=args.batch_size,
                          epochs=args.epochs, grad_clip=args.grad_clip,
                          batch_order=args.batch_order,
                          fused_update=args.fused_update,
                          precision=args.precision,
                          loss_scale=args.loss_scale),
        fed=FedConfig(client_num_in_total=args.client_num_in_total,
                      frac=args.frac, comm_round=args.comm_round,
                      frequency_of_the_test=args.frequency_of_the_test,
                      ci=bool(args.ci),
                      lamda=args.lamda, local_epochs=args.local_epochs,
                      cs=args.cs, neighbor_num=args.neighbor_num,
                      active=args.active, fomo_m=args.fomo_m,
                      rounds_per_dispatch=args.rounds_per_dispatch,
                      client_mesh=args.client_mesh,
                      mpc_n_shares=args.mpc_n_shares,
                      mpc_frac_bits=args.mpc_frac_bits,
                      mpc_backend=args.mpc_backend,
                      secure_quant=args.secure_quant,
                      secure_quant_field_bits=args.secure_quant_field_bits,
                      secure_quant_frac_bits=args.secure_quant_frac_bits,
                      defense_type=args.defense_type,
                      norm_bound=args.norm_bound, stddev=args.stddev,
                      byz_f=args.byz_f, geomed_iters=args.geomed_iters,
                      dp_clip=args.dp_clip, dp_sigma=args.dp_sigma,
                      dp_delta=args.dp_delta, fault_spec=args.fault_spec,
                      wire_codec=args.wire_codec,
                      wire_topk_ratio=args.wire_topk_ratio),
        sparsity=SparsityConfig(
            dense_ratio=args.dense_ratio, anneal_factor=args.anneal_factor,
            erk_power_scale=args.erk_power_scale, uniform=args.uniform,
            static=args.static, dis_gradient_check=args.dis_gradient_check,
            different_initial=args.different_initial, diff_spa=args.diff_spa,
            snip_mask=not args.no_snip_mask,
            itersnip_iterations=args.itersnip_iteration,
            stratified_sampling=args.stratified_sampling,
            each_prune_ratio=args.each_prune_ratio,
            dist_thresh=args.dist_thresh, acc_thresh=args.acc_thresh,
            save_masks=args.save_masks),
    )


DATASETS = ("abcd", "abcd_h5", "synthetic", *VISION_CLASSES)


def build_experiment(cfg: ExperimentConfig, device: str = "cuda",
                     streaming: bool = False):
    """Data (``cfg.data.dataset``: the HDF5 file at ``data_dir``, the
    synthetic cohort, or a vision dataset) -> federation (by
    ``partition_method``, with a validation split where ``val_fraction >
    0``), resident on the device or, under ``streaming`` (site clients of a
    cohort only), a ``StreamingFederation`` over the host's copy -> model
    (for the data's sample shape, in the precision's compute dtype, with
    the resolved remat policy) -> trainer -> engine. Returns ``(engine,
    partition_info)``; ``partition_info["file"]`` is the HDF5 file a
    streamed run reads, for the caller to close (None otherwise). The
    engine gets the run's device mesh (:func:`build_mesh`), and a resident
    federation is padded to a multiple of its size."""
    from neuroimagedisttraining_tpu_torch.core.optim import (
        compute_dtype, resolve_remat,
    )
    from neuroimagedisttraining_tpu_torch.core.trainer import LocalTrainer
    from neuroimagedisttraining_tpu_torch.data.federate import (
        federate_cohort, federation_maps,
    )
    from neuroimagedisttraining_tpu_torch.data.hdf5 import load_abcd_hdf5
    from neuroimagedisttraining_tpu_torch.data.stream import (
        StreamingFederation,
    )
    from neuroimagedisttraining_tpu_torch.data.synthetic import (
        generate_synthetic_abcd,
    )
    from neuroimagedisttraining_tpu_torch.data.vision import federate_vision
    from neuroimagedisttraining_tpu_torch.device import resolve_device
    from neuroimagedisttraining_tpu_torch.models import create_model

    dev = resolve_device(device)
    mesh = build_mesh(cfg, dev, streaming)
    mesh_size = mesh.devices.size if mesh is not None else 1
    d = cfg.data
    dataset = d.dataset.lower()
    if dataset not in DATASETS:
        raise ValueError(f"dataset {dataset!r} has no loader in the port "
                         f"(have: {'/'.join(DATASETS)})")
    fed = stream = None
    if dataset in VISION_CLASSES:
        if streaming:
            raise ValueError("streaming mode is for ABCD-scale cohorts")
        fed, info = federate_vision(
            "cifar10" if dataset == "synthetic_vision" else dataset,
            d.data_dir,
            "dir" if d.partition_method == "site" else d.partition_method,
            d.partition_alpha, cfg.fed.client_num_in_total, dev,
            val_fraction=d.val_fraction, seed=cfg.seed,
            synthetic=dataset == "synthetic_vision",
            num_classes=cfg.num_classes if cfg.num_classes > 1 else None,
            mesh_size=mesh_size)
        info["file"] = None
        shape = tuple(fed.X_train.shape[2:])
    else:
        if streaming and d.partition_method != "site":
            raise ValueError("streaming mode currently partitions by site")
        if dataset == "synthetic":
            cohort = generate_synthetic_abcd(
                num_subjects=d.synthetic_num_subjects,
                shape=d.synthetic_shape, signal=d.synthetic_signal,
                num_sites=max(4, cfg.fed.client_num_in_total // 4),
                seed=cfg.seed)
        else:
            cohort = load_abcd_hdf5(d.data_dir, lazy=streaming)
        if streaming:
            train_map, test_map, val_map, info = federation_maps(
                cohort["site"], d.seed_split, d.val_fraction)
            stream = StreamingFederation(
                cohort["X"], cohort["y"], train_map, test_map,
                val_map=val_map, device=dev)
        else:
            fed, info = federate_cohort(
                cohort, dev, d.seed_split, d.val_fraction,
                partition_method=d.partition_method,
                client_number=cfg.fed.client_num_in_total,
                alpha=d.partition_alpha, mesh_size=mesh_size)
        info["file"] = cohort.get("file")
        shape = tuple(cohort["X"].shape[1:])
    o = cfg.optim
    model = create_model(cfg.model, shape, cfg.num_classes,
                         dtype=compute_dtype(o.precision),
                         remat=resolve_remat(cfg.remat, o.precision,
                                             o.batch_size))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    trainer = LocalTrainer(model, o, dev, gen, num_classes=cfg.num_classes)
    return create_engine(cfg.algorithm, cfg, fed, trainer,
                         stream=stream, mesh=mesh), info


def build_mesh(cfg: ExperimentConfig, dev, streaming: bool = False):
    """The run's device mesh, as the reference's CLI builds it: none for a
    plain streamed run; ``--client_mesh N`` (without ``--mesh_shape``) the
    1-D mesh of N entries; else ``--mesh_shape`` (by default every device)
    over the visible devices, or ``--virtual_devices`` entries of the run's
    device."""
    from neuroimagedisttraining_tpu_torch.parallel.mesh import (
        make_mesh, virtual_devices, visible_devices,
    )

    if streaming and not cfg.mesh_shape and not cfg.fed.client_mesh:
        return None
    devices = (virtual_devices(cfg.virtual_devices, dev)
               if cfg.virtual_devices else visible_devices(dev))
    if cfg.fed.client_mesh > 0 and not cfg.mesh_shape:
        return make_mesh(num_devices=cfg.fed.client_mesh, devices=devices)
    return make_mesh(shape=cfg.mesh_shape, devices=devices)


def check_privacy_flags(parser: argparse.ArgumentParser, args) -> None:
    """The privacy-plane conflicts the reference's CLI refuses at argparse
    (the engine constructors refuse them too, after the data build)."""
    from neuroimagedisttraining_tpu_torch.core import robust

    if args.algorithm.lower() == "turboaggregate":
        if args.wire_codec not in ("", "none"):
            parser.error(
                "--wire_codec does not compose with the secure "
                "turboaggregate engine (the codec's float stages would "
                "corrupt the GF(p) share embedding)")
        if args.defense_type in robust.ROBUST_AGGREGATORS:
            parser.error(
                f"--defense {args.defense_type} does not compose with "
                "secure aggregation (no per-client plaintext to select "
                "over); the clip family (norm_diff_clipping, weak_dp) "
                "composes client-side")
    if args.dp_sigma > 0 and args.dp_clip <= 0:
        parser.error("--dp_sigma needs --dp_clip > 0 (the clip bound is "
                     "the sensitivity the noise multiplier is stated "
                     "against)")
    if args.dp_sigma > 0 or args.dp_clip > 0:
        cls = ENGINES.get(args.algorithm.lower())
        if cls is None or not cls.supports_dp:
            ok = sorted({c.name for c in ENGINES.values() if c.supports_dp})
            parser.error(
                f"--dp_clip/--dp_sigma need an engine with the round-"
                f"level DP transform; algorithm {args.algorithm!r} "
                f"would train un-noised while the accountant reported "
                f"epsilon (supported: {ok})")
    if args.secure_quant:
        from neuroimagedisttraining_tpu_torch.privacy import (
            QuantSpec, check_headroom,
        )

        cls = ENGINES.get(args.algorithm.lower())
        if cls is None or not cls.supports_secure_quant:
            ok = sorted({c.name for c in ENGINES.values()
                         if c.supports_secure_quant})
            parser.error(
                f"--secure_quant needs an engine whose round has the "
                f"default aggregation tail; algorithm "
                f"{args.algorithm!r} has no server fold for the field "
                f"algebra to replace (supported: {ok})")
        if args.wire_codec not in ("", "none"):
            parser.error(
                "--secure_quant does not compose with --wire_codec "
                "(the codec's float stages would corrupt the GF(p) "
                "residue embedding)")
        if args.defense_type in robust.ROBUST_AGGREGATORS:
            parser.error(
                f"--defense {args.defense_type} does not compose with "
                "--secure_quant (no per-client plaintext to select "
                "over); the clip family (norm_diff_clipping, weak_dp) "
                "composes client-side")
        try:
            check_headroom(
                QuantSpec.from_bits(args.secure_quant_field_bits,
                                    args.secure_quant_frac_bits,
                                    args.mpc_n_shares),
                args.client_num_in_total)
        except ValueError as e:
            parser.error(str(e))


def main(argv: list[str] | None = None) -> int:
    parser = add_args(argparse.ArgumentParser(
        prog="neuroimagedisttraining_tpu_torch"))
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    try:  # the precision contract (--loss_scale, Adam's --fused_update)
        validate_precision(cfg.optim)
    except ValueError as e:
        parser.error(str(e))
    if args.algorithm == "fedfomo" and args.val_fraction <= 0:
        parser.error("--algorithm fedfomo needs a validation split: give "
                     "--val_fraction > 0")
    check_privacy_flags(parser, args)
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout)
    engine, info = build_experiment(cfg, args.device,
                                    streaming=args.streaming)
    logging.info("partition: %s", json.dumps(info["train_counts"]))
    try:
        result = engine.train()
    finally:
        if engine.stream is not None:
            engine.stream.close()
        if info["file"] is not None:
            info["file"].close()
    print(json.dumps({k: v for k, v in result.items()
                      if not _holds_tensor(v)}))
    return 0


def _holds_tensor(v) -> bool:
    """A model state (or anything else holding a tensor): not printed."""
    if isinstance(v, torch.Tensor):
        return True
    if isinstance(v, dict):
        return any(_holds_tensor(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return any(_holds_tensor(x) for x in v)
    return False


if __name__ == "__main__":
    sys.exit(main())
