"""Privacy plane: the RDP accountant of the DP noise paths (the
``weak_dp`` defense and D-PSGD's ``--dp_clip`` / ``--dp_sigma``)."""

from neuroimagedisttraining_tpu_torch.privacy.accountant import (  # noqa: F401
    DEFAULT_ORDERS,
    RDPAccountant,
    rdp_gaussian,
    rdp_to_epsilon,
    weak_dp_noise_multiplier,
)
