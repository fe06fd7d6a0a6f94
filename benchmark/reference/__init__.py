"""The benchmark's plain PyTorch reference: the model, its random draws and
Adam, written from the published descriptions. Imports torch only."""
