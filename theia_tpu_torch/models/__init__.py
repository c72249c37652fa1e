"""Theia student model in PyTorch: ViT backbone, lconv translator heads, weight conversion."""
