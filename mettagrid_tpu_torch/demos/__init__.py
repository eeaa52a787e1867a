"""Demos of the port, runnable as modules:
``python -m mettagrid_tpu_torch.demos.demo_train`` and
``python -m mettagrid_tpu_torch.demos.demo_pettingzoo``."""
