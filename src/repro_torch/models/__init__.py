"""LM substrate in torch: dense-family blocks, attention, MLPs."""
