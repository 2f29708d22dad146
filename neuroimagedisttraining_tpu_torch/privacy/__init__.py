"""Privacy plane: the RDP accountant of the DP noise paths (the
``weak_dp`` defense and D-PSGD's ``--dp_clip`` / ``--dp_sigma``) and
secure quantized aggregation (``secure_quant``: field-element frames over
a small GF(p), the host protocol whose fold the engines' ``--secure_quant``
runs on the device)."""

from neuroimagedisttraining_tpu_torch.privacy.accountant import (  # noqa: F401
    DEFAULT_ORDERS,
    RDPAccountant,
    rdp_gaussian,
    rdp_to_epsilon,
    weak_dp_noise_multiplier,
)
from neuroimagedisttraining_tpu_torch.privacy.secure_quant import (  # noqa: F401
    QuantSpec,
    SlotAccumulator,
    check_headroom,
    encode_secure_quant,
    integer_weights,
    is_secure_quant_frame,
    leaf_scales,
    quantized_weighted_mean,
    weighted_fold_capacity,
)
