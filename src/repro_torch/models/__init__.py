"""Model zoo (the dense all-attention decoder path so far)."""
