"""Generated compatibility matrix — DO NOT EDIT BY HAND.

Extracted from the tree's startup-rejection sites (``parser.error`` /
``ap.error`` in the CLIs, ``raise ValueError`` in ctors and in the
declared startup validators, ``config.py`` ``STARTUP_VALIDATORS``) by
the contract checker (analysis/contracts.py). Each row names WHERE the
rejection lives, WHICH knobs its guard reads, and the message — the
machine-readable twin of analysis/COMPAT_MATRIX.md's table.

Regenerate (also rewrites the COMPAT_MATRIX.md block)::

    python -m neuroimagedisttraining_tpu_torch.analysis --regen-compat

The project pass (``--project``) diffs this artifact against a fresh
extraction (``compat-matrix-drift``) and the markdown twin against
this artifact (``compat-matrix-doc-stale``), so a new startup rejection
without a regenerated matrix — or a hand-edited table — fails the
lint.
"""

from __future__ import annotations

from typing import Any

MATRIX: tuple[dict[str, Any], ...] = (
    {
        "where": 'neuroimagedisttraining_tpu_torch/__main__.py',
        "knobs": ('algorithm', 'defense_type'),
        "message": (
            '--defense does not compose with secure aggregation (no per-c'
            'lient plaintext to select over); the clip family (norm_diff_'
            'clipping, weak_dp) c'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/__main__.py',
        "knobs": ('algorithm', 'val_fraction'),
        "message": (
            '--algorithm fedfomo needs a validation split: give --val_fra'
            'ction > 0'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/__main__.py',
        "knobs": ('algorithm', 'wire_codec'),
        "message": (
            '--wire_codec does not compose with the secure turboaggregate'
            " engine (the codec's float stages would corrupt the GF(p) sh"
            'are embedding)'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/__main__.py',
        "knobs": ('defense_type', 'dp_epsilon_budget', 'dp_sigma'),
        "message": (
            '--dp_epsilon_budget needs an armed noise path to budget (--d'
            'p_sigma/--dp_clip on a DP engine, or --defense weak_dp): wit'
            'hout one the account'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/__main__.py',
        "knobs": ('defense_type', 'secure_quant'),
        "message": (
            '--defense does not compose with --secure_quant (no per-clien'
            't plaintext to select over); the clip family (norm_diff_clip'
            'ping, weak_dp) compo'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/__main__.py',
        "knobs": ('dp_clip', 'dp_sigma'),
        "message": (
            '--dp_clip/--dp_sigma need an engine with the round-level DP '
            'transform; algorithm would train un-noised while the account'
            'ant reported epsilon'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/__main__.py',
        "knobs": ('dp_clip', 'dp_sigma'),
        "message": (
            '--dp_sigma needs --dp_clip > 0 (the clip bound is the sensit'
            'ivity the noise multiplier is stated against)'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/__main__.py',
        "knobs": ('secure_quant', 'wire_codec'),
        "message": (
            '--secure_quant does not compose with --wire_codec (the codec'
            "'s float stages would corrupt the GF(p) residue embedding)"),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/core/optim.py',
        "knobs": ('client_optimizer', 'fused_update'),
        "message": (
            '--fused_update fuses the SGD clip/momentum/update tail (ops/'
            'fused_update.py); client_optimizer= has no fused kernel and '
            'would silently train'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/core/optim.py',
        "knobs": ('loss_scale', 'precision'),
        "message": (
            'loss_scale= needs precision=bf16_mixed: under fp32 the scale'
            '/unscale pair would only perturb rounding and break the bitw'
            'ise-f32 contract'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('async_server', 'buffer_k', 'max_staleness', 'staleness_alpha'),
        "message": (
            '--buffer_k/--max_staleness/--staleness_alpha must be >= 0'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('async_server', 'ingest_workers'),
        "message": (
            '--ingest_workers shards the ASYNC ingest plane (asyncfl/inge'
            'st.py) — add --async_server'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('async_server', 'quorum', 'round_deadline'),
        "message": (
            '--async_server has no round barrier: --round_deadline/--quor'
            'um do not apply (uploads aggregate every --buffer_k arrivals'
            '; staleness is bound'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('async_server', 'secure', 'secure_quant'),
        "message": (
            '--async_server is incompatible with dense --secure: the two-'
            "phase secure weight exchange (every client's normalized weig"
            'ht depends on every '),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('async_server', 'transport'),
        "message": (
            '--async_server pairs with the selector socket core (asyncfl/'
            'loop.py); the broker daemon is a thread-per-connection trans'
            'port with its own sc'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('defense', 'ingest_workers', 'quarantine_rounds'),
        "message": (
            '--ingest_workers supports neither server-side defenses nor q'
            'uarantine: workers fold uploads into partial aggregates, so '
            'the root never sees '),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('defense', 'secure', 'secure_quant'),
        "message": (
            '--defense is incompatible with secure aggregation (quantized'
            ' included): order statistics have no per-silo plaintext to s'
            'elect over; only the'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('defense', 'secure', 'secure_quant'),
        "message": (
            '--secure (dense) is incompatible with --defense: additive-sh'
            'are aggregation never reveals per-silo updates to defend ove'
            'r. The clip-family d'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('fault_spec', 'secure'),
        "message": (
            '--secure cannot simulate byz: value faults (the share algebr'
            'a hides the very values the attack would corrupt; see cross_'
            'silo)'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('heartbeat_interval', 'heartbeat_timeout'),
        "message": (
            '--heartbeat_timeout requires 0 < --heartbeat_interval < time'
            'out (got interval= , timeout= )'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('ingest_shm', 'ingest_workers', 'sync_delta'),
        "message": (
            '--ingest_shm/--sync_delta are sharded-ingest-plane transport'
            's (asyncfl/ingest.py) — add --ingest_workers N'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('ingest_workers', 'regions'),
        "message": (
            '--regions interposes regional sub-aggregators in the SHARDED'
            ' ingest plane — pass --ingest_workers N (workers per region)'
            ' too'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('mpc_n_shares', 'n_aggregators'),
        "message": (
            '--n_aggregators ( ) must equal --mpc_n_shares ( ): slot j ro'
            'utes to aggregator j'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('n_aggregators', 'role'),
        "message": (
            '--role aggregator requires --n_aggregators > 0 (same value o'
            'n every rank)'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('n_aggregators', 'role', 'slot_index'),
        "message": (
            '--slot_index ( ) must be in [0, )'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('n_aggregators', 'secure'),
        "message": (
            '--n_aggregators requires --secure'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('n_aggregators', 'secure_quant'),
        "message": (
            '--secure_quant does not compose with --n_aggregators: mask s'
            "lots ride as PRG seeds, and any node holding a client's seed"
            's can expand every n'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('n_aggregators', 'transport'),
        "message": (
            '--transport broker routes messages through the MQTT topic sc'
            'heme (server <-> client only); the grouped multi-aggregator '
            'deployment needs --t'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('quarantine_rounds', 'secure'),
        "message": (
            'secure aggregation is incompatible with --quarantine_rounds:'
            ' the outlier scorer has no per-silo plaintext to score (see '
            "ARCHITECTURE.md 'Pri"),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/distributed/run.py',
        "knobs": ('secure', 'wire_codec', 'wire_mask_density'),
        "message": (
            '--secure uploads must ride the wire as field elements: the c'
            'odec would break the GF(p) share algebra or leak mask suppor'
            't. The COMPRESSED se'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/engines/base.py',
        "knobs": ('defense_type', 'fed'),
        "message": (
            'algorithm does not support --defense ; this engine supports:'
            ' ,'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/engines/base.py',
        "knobs": ('defense_type', 'fed', 'secure_quant'),
        "message": (
            '--defense does not compose with --secure_quant (no per-clien'
            't plaintext to select over); the clip family (norm_diff_clip'
            'ping, weak_dp) compo'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/engines/base.py',
        "knobs": ('dp_clip', 'dp_sigma', 'fed'),
        "message": (
            '--dp_sigma needs --dp_clip > 0: the clip bound IS the sensit'
            'ivity the noise multiplier is stated against (privacy/accoun'
            'tant.py)'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/engines/base.py',
        "knobs": ('dp_clip', 'dp_sigma', 'fed'),
        "message": (
            'algorithm does not apply the --dp_clip/--dp_sigma round-leve'
            'l DP transform (its round program would train un-noised whil'
            'e the accountant rep'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/engines/base.py',
        "knobs": ('dp_clip', 'dp_sigma', 'fed'),
        "message": (
            'dp_sigma/dp_clip must be >= 0 (got / )'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/engines/base.py',
        "knobs": ('fed', 'secure_quant'),
        "message": (
            '--secure_quant does not compose with --wire_codec: the codec'
            "'s float stages would corrupt the GF(p) residue embedding (f"
            'ield-element frames,'),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/engines/base.py',
        "knobs": ('fed', 'secure_quant'),
        "message": (
            '--secure_quant field too small for the in-process integer-we'
            "ight fold: a -client cohort exceeds the -bit field's capacit"
            'y of weight units — '),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/engines/base.py',
        "knobs": ('fed', 'secure_quant'),
        "message": (
            'algorithm does not simulate --secure_quant: its round has no'
            ' default server-side aggregation tail for the field fold to '
            'replace; supported: '),
    },
    {
        "where": 'neuroimagedisttraining_tpu_torch/engines/turboaggregate.py',
        "knobs": ('fed', 'mpc_backend'),
        "message": (
            'unknown mpc_backend (have )'),
    },
)
