"""Plain NumPy references of the games the benchmark's cells run.

``reference/<game>.py`` follows the game's rules from the map grids, the
configuration file and the traffic's inputs alone; ``maps/<kind>.py`` draws
the map grids from the configuration file and a seed. Neither imports
anything of the program under test (mettagrid_tpu_torch), nor jax or the JAX
package.
"""
