from repro_torch.serving.engine import GenerationRequest, ServingEngine  # noqa: F401
