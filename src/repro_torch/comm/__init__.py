from repro_torch.comm.collective import StackedCollective  # noqa: F401
from repro_torch.comm.engine import HaloExchangeEngine  # noqa: F401
from repro_torch.comm.plan import (ExchangePlan,  # noqa: F401
                                   build_exchange_plan)
