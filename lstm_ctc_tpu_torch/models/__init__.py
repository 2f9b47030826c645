from .registry import apply_model, get_model, init_model
