from repro_torch.optim.adamw import (  # noqa: F401
    OptState,
    adamw_init,
    adamw_update,
)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
