from repro_torch.models.api import build_model, MODEL_REGISTRY  # noqa: F401
