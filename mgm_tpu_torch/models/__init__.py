from .presets import PRESETS, get_preset
