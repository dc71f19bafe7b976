"""The benchmark's plain reference: float32 PyTorch models written anew
from the papers (stereo.py), the float8 control's operand rounding
(precision.py) and the error measures (metrics.py). Nothing here imports
the program under test or the JAX package."""
