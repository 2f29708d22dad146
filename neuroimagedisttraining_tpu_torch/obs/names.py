"""The declared metric-name table: every ``nidt_*`` series, in one home
(the reference package's ``obs/names.py``, the same names).

The anomaly-rule engine (``obs/rules.py``) turns metric names into
verdicts, so a mistyped name in a rule manifest fails at startup against
this list. Each name is declared once; instrumentation sites spell the
constant. Registration (kind, labels, help) stays at the site. The port
publishes the engine, health, compute, rule, action, fan-in, serving,
transport and synchronous cross-silo series; the others (the reference's
asynchronous plane) stay declared so that a manifest written for the
reference validates here.
"""

from __future__ import annotations

# -- control-plane transports (distributed/comm.py) --
COMM_BYTES_SENT = "nidt_comm_bytes_sent_total"
COMM_BYTES_RECV = "nidt_comm_bytes_recv_total"
COMM_FRAMES_SENT = "nidt_comm_frames_sent_total"
COMM_FRAMES_RECV = "nidt_comm_frames_recv_total"

# -- synchronous cross-silo server (distributed/cross_silo.py) --
SYNC_UPLOADS = "nidt_sync_uploads_total"
SYNC_ROUND_WALL = "nidt_sync_round_wall_seconds"
SYNC_QUORUM_WAIT = "nidt_sync_quorum_wait_seconds"
SERVER_ROUND = "nidt_server_round"
SERVER_SUSPECTS = "nidt_server_suspects"
BYZ_STRIKES = "nidt_byz_strikes_total"
BYZ_QUARANTINES = "nidt_byz_quarantines_total"
DP_EPSILON_SILO = "nidt_dp_epsilon_silo"

# -- async buffered server (asyncfl/server.py) --
ASYNC_UPLOADS = "nidt_async_uploads_total"
ASYNC_STALENESS = "nidt_async_staleness"
ASYNC_BUFFER_OCCUPANCY = "nidt_async_buffer_occupancy"
ASYNC_BUFFER_K_EFF = "nidt_async_buffer_k_eff"

# -- selector socket core (asyncfl/loop.py) --
SELECTOR_CONNECTIONS = "nidt_selector_connections"
SELECTOR_WRITE_QUEUE = "nidt_selector_write_queue_frames"
BACKPRESSURE_STALLS = "nidt_backpressure_stalls_total"

# -- sharded ingest plane (asyncfl/ingest.py) --
INGEST_HEARTBEATS_SUPPRESSED = "nidt_ingest_heartbeats_suppressed"
INGEST_PENDING_UPLOADS = "nidt_ingest_pending_uploads"
INGEST_WORKERS_LIVE = "nidt_ingest_workers_live"
INGEST_PARTIALS = "nidt_ingest_partials_total"
INGEST_WORKER_UPLOADS = "nidt_ingest_worker_uploads_total"

# -- hierarchical aggregation tier (asyncfl/region.py) --
REGION_STALENESS = "nidt_region_staleness"
REGION_PARTIAL_AGE = "nidt_region_partial_age_s"

# -- telemetry fan-in (obs/fanin.py) --
UPLOAD_STAGE_MS = "nidt_upload_stage_ms"
CLIENT_RTT_MS = "nidt_client_rtt_ms"
OBS_WORKER_SNAPSHOT_AGE = "nidt_obs_worker_snapshot_age_s"
OBS_WORKER_ALIVE = "nidt_obs_worker_alive"

# -- compute-plane profiler (obs/compute.py); XLA_FLOPS is the
#    reference's cost_analysis count, the port's FlopCounterMode count --
COMPILES_TOTAL = "nidt_compiles_total"
RECOMPILES_TOTAL = "nidt_recompiles_total"
DISPATCH_MS = "nidt_dispatch_ms"
SUSTAINED_TFLOPS = "nidt_sustained_tflops"
MFU = "nidt_mfu"
XLA_FLOPS = "nidt_xla_flops"
FLOPS_PARITY_RATIO = "nidt_flops_parity_ratio"
HBM_PEAK_BYTES = "nidt_hbm_peak_bytes"

# -- engine host boundaries (engines/base.py, engines/program.py) --
STAT = "nidt_stat"
DP_EPSILON = "nidt_dp_epsilon"
DP_EPSILON_PER_ROUND = "nidt_dp_epsilon_per_round"
ENGINE_ROUND = "nidt_engine_round"
FALLBACK_TOTAL = "nidt_fallback_total"

# -- experiment metrics (utils/logging.py) --
EXP_METRIC = "nidt_exp_metric"
EXP_ROUND = "nidt_exp_round"

# -- streamed feed (data/stream.py) --
STREAM_TRANSFER = "nidt_stream_transfer"

# -- training-health plane (obs/health.py publishes, the stats are
#    computed on the device in the round's tail, engines/program.py) --
HEALTH_UPDATE_NORM = "nidt_health_update_norm"
HEALTH_UPDATE_NORM_MAX = "nidt_health_update_norm_max"
HEALTH_UPDATE_NORM_MED = "nidt_health_update_norm_med"
HEALTH_COSINE_MIN = "nidt_health_cosine_min"
HEALTH_COSINE_MEAN = "nidt_health_cosine_mean"
HEALTH_DIVERGENCE = "nidt_health_divergence"
HEALTH_PARAM_NORM = "nidt_health_param_norm"
HEALTH_AGG_UPDATE_NORM = "nidt_health_agg_update_norm"
HEALTH_MASK_DENSITY = "nidt_health_mask_density"
HEALTH_MASK_OVERLAP = "nidt_health_mask_overlap"
HEALTH_MASK_CHURN = "nidt_health_mask_churn"
HEALTH_ROUND = "nidt_health_round"

# -- serving plane (serve/engine.py, serve/worker.py, serve/server.py) --
SERVE_LATENCY_MS = "nidt_serve_latency_ms"
SERVE_BATCH_OCCUPANCY = "nidt_serve_batch_occupancy"
SERVE_QUEUE_DEPTH = "nidt_serve_queue_depth"
SERVE_REQUESTS = "nidt_serve_requests_total"
SERVE_WORKERS_LIVE = "nidt_serve_workers_live"
SERVE_WORKER_REQUESTS = "nidt_serve_worker_requests_total"

# -- anomaly-rule engine (obs/rules.py) --
ALERT = "nidt_alert"

# -- reflex plane (obs/actions.py): rule->action dispatches
#    by action name and outcome status (applied / dry_run / unhandled /
#    skipped / error) --
ACTIONS_TOTAL = "nidt_actions_total"

# -- autotuner recipes (tune/recipe.py): the loaded recipe's recorded
#    score, published so the mfu-below-recipe drift rule's threshold is
#    scrapeable next to the live nidt_mfu it is compared against --
RECIPE_SCORE = "nidt_recipe_score"

#: every declared metric name — the set obs/rules.py validates rule
#: manifests against at startup (unknown names fail with this list)
DECLARED: frozenset[str] = frozenset(
    v for v in list(globals().values())
    if isinstance(v, str) and v.startswith("nidt_"))
