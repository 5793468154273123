"""Runs the JAX package's CLI, ``mistra_tpu.cli.main``, on the CPU with
two changes made from outside the package:

- the init's radiation call (and, with chemistry, its photolysis call) is
  jitted, as ``_torch_parity.jax_init`` makes it: op by op it takes ~40 s
  on a CPU for the same result;
- the clock's minute is set after ``init_state`` (the configuration has
  no start minute, only ``nhour``), so that a short run crosses an hour;
- with STEP ``pre_minute``, the minute step only advances the clock and
  the deposition velocities (``Model.pre_minute``), so that a run reaches
  the 15-minute snapshot's diagnostics in seconds; ``minute_step`` keeps
  the model's step.

Usage: python tests/_jax_cli.py START_MINUTE STEP <mistra_tpu CLI arguments>
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

from mistra_tpu.cli import main  # noqa: E402
from mistra_tpu.model import Model  # noqa: E402
from mistra_tpu.radiation.driver import RadiationDriver  # noqa: E402


def init_state_at(minute):
    def init_state(self):
        self.radiation_enabled = False
        s = Model._init_state_impl(self)
        self.radiation_enabled = True
        self._radiation = RadiationDriver(self)
        self._radiation.build_static(s)
        s = jax.jit(self._radiation)(s)
        if self._chemistry is not None:
            from mistra_tpu.photolysis.jrates import PhotolysisDriver
            self._photolysis = PhotolysisDriver(self, self._radiation)
            pj = jnp.where(s.rad.u0 > self._chemistry.u0min,
                           jax.jit(self._photolysis)(s), 0.0)
            s = s.replace(chem=s.chem.replace(photol_j=pj))
        return s.replace(tim=s.tim.replace(lmin=jnp.int32(minute)))
    return init_state


if __name__ == "__main__":
    Model.init_state = init_state_at(int(sys.argv[1]))
    Model.minute_step = getattr(Model, sys.argv[2])
    sys.exit(main(sys.argv[3:] + ["--platform", "cpu"]))
