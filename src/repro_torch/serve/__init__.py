from repro_torch.serve.engine import ModelStepper, ServeConfig, ServingEngine

__all__ = ["ModelStepper", "ServeConfig", "ServingEngine"]
