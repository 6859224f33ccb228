"""Model constructors of the port (heat, Laplacian, 3D diffusion and its
sharded form — config #5 —, wave, elastic, lattice Boltzmann, advection,
Burgers, phase field) and the wave model's FWI helpers.  Constructors
are memoized (``_memo.memoize_model``): equal arguments give the same
op."""

from .advection import upwind1_op, weno5_op, weno5_rk3_stages
from .burgers import burgers2d_op
from .diffusion import diffusion3d_op, sharded_diffusion3d
from .elastic import (anisotropic27_op, elastic_stages, elastic_stress_op,
                      elastic_velocity_op)
from .heat import (heat_step3d_op, heat_step_op, laplacian3d_op,
                   laplacian_op)
from .lbm import (D2Q9_VELOCITIES, D2Q9_WEIGHTS, D3Q19_VELOCITIES,
                  D3Q19_WEIGHTS, bgk_op, d2q9_bgk_op, d3q19_bgk_op,
                  macroscopic)
from .phasefield import (allen_cahn_op, cahn_hilliard_stages, ch_update_op,
                         chemical_potential_op, ginzburg_landau_energy)
from .wave import fwi_gradient, wave_simulate, wave_step_op

__all__ = ["laplacian_op", "laplacian3d_op", "heat_step_op", "heat_step3d_op",
           "diffusion3d_op", "sharded_diffusion3d", "wave_step_op",
           "wave_simulate", "fwi_gradient",
           "anisotropic27_op", "elastic_velocity_op", "elastic_stress_op",
           "elastic_stages", "bgk_op", "d2q9_bgk_op", "d3q19_bgk_op",
           "macroscopic", "D2Q9_VELOCITIES", "D2Q9_WEIGHTS",
           "D3Q19_VELOCITIES", "D3Q19_WEIGHTS", "upwind1_op", "weno5_op",
           "weno5_rk3_stages", "burgers2d_op", "allen_cahn_op",
           "chemical_potential_op", "ch_update_op", "cahn_hilliard_stages",
           "ginzburg_landau_energy"]
