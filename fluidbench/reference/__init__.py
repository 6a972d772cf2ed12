"""A plain PyTorch and numpy reference of the fluid step and frame, written
from the WebGL reference's algorithm. It imports nothing of the program
under test."""
