from .adam_decay import AdamDecay, AdamDecayState, adam_decay, apply_updates, reinit_moments

__all__ = ["AdamDecay", "AdamDecayState", "adam_decay", "apply_updates", "reinit_moments"]
