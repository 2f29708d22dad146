"""Federated engines, by the reference CLI's algorithm names."""

from neuroimagedisttraining_tpu_torch.engines.base import FederatedEngine
from neuroimagedisttraining_tpu_torch.engines.dispfl import DisPFLEngine
from neuroimagedisttraining_tpu_torch.engines.ditto import DittoEngine
from neuroimagedisttraining_tpu_torch.engines.dpsgd import DPSGDEngine
from neuroimagedisttraining_tpu_torch.engines.fedavg import FedAvgEngine
from neuroimagedisttraining_tpu_torch.engines.fedfomo import FedFomoEngine
from neuroimagedisttraining_tpu_torch.engines.fedprox import FedProxEngine
from neuroimagedisttraining_tpu_torch.engines.local import LocalEngine
from neuroimagedisttraining_tpu_torch.engines.salientgrads import (
    SalientGradsEngine,
)
from neuroimagedisttraining_tpu_torch.engines.subavg import SubFedAvgEngine
from neuroimagedisttraining_tpu_torch.engines.turboaggregate import (
    TurboAggregateEngine,
)

ENGINES = {
    "fedavg": FedAvgEngine,
    "fedprox": FedProxEngine,
    "salientgrads": SalientGradsEngine,
    "sailentgrads": SalientGradsEngine,  # the reference's spelling
    "ditto": DittoEngine,
    "local": LocalEngine,
    "subavg": SubFedAvgEngine,
    "sub-fedavg": SubFedAvgEngine,
    "dispfl": DisPFLEngine,
    "dpsgd": DPSGDEngine,
    "fedfomo": FedFomoEngine,
    "turboaggregate": TurboAggregateEngine,
}


def create_engine(name: str, *args, **kwargs) -> FederatedEngine:
    try:
        cls = ENGINES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown algorithm {name!r}; have {sorted(ENGINES)}")
    return cls(*args, **kwargs)
