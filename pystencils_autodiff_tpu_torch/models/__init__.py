"""Model constructors of the port (heat, Laplacian, 3D diffusion, wave)
and the wave model's FWI helpers."""

from .diffusion import diffusion3d_op
from .heat import heat_step3d_op, heat_step_op, laplacian_op
from .wave import fwi_gradient, wave_simulate, wave_step_op

__all__ = ["laplacian_op", "heat_step_op", "heat_step3d_op",
           "diffusion3d_op", "wave_step_op", "wave_simulate", "fwi_gradient"]
