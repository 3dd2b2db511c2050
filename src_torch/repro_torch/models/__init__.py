"""The model substrate of the port (port of ``repro/models``): the dense
attention transformer and its blocks."""
from repro_torch.models.api import (  # noqa: F401
    Model, build_model, params_from_reference, to_arrays,
    train_state_from_reference, train_state_to_arrays,
)
