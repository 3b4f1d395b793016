"""Utilities of the PyTorch port: device policy, configs, weight bridge."""

from .env import default_device, set_precision_policy  # noqa: F401
