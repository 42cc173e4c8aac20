from amgx_tpu_torch.config.amg_config import AMGConfig
from amgx_tpu_torch.config.params import PARAMS, ParameterDescription

__all__ = ["AMGConfig", "PARAMS", "ParameterDescription"]
