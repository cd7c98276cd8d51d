"""The model registry (port of ``diffspectra_tpu/utils/registry.py``):
``create_model(config)`` builds the model that ``config.model.name`` names
through its ``from_config``. The models register themselves on import;
``get_model_cls`` imports the port's model modules first."""

from __future__ import annotations

_MODELS = {}
# registered in the JAX package, not yet in the port
NOT_PORTED = ()


def register_model(cls=None, *, name=None):
    def _register(cls):
        local_name = cls.__name__ if name is None else name
        if local_name in _MODELS:
            raise ValueError(f"Model {local_name!r} already registered")
        _MODELS[local_name] = cls
        return cls

    if cls is None:
        return _register
    return _register(cls)


def get_model_cls(name: str):
    from ..models import cdgs, dmt, dmt_wo_eq  # noqa: F401 (they register themselves)

    if name in NOT_PORTED:
        raise ValueError(f"Model {name!r} is not yet ported; registered: {sorted(_MODELS)}")
    if name not in _MODELS:
        raise ValueError(f"Unknown model {name!r}; registered: {sorted(_MODELS)}")
    return _MODELS[name]


def create_model(config):
    """The ``torch.nn.Module`` for ``config.model.name``, its parameters
    empty until loaded (``warm_state.load_model_state``)."""
    return get_model_cls(config.model.name).from_config(config)
