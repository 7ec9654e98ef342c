"""wandb helper (port of ``rlaopt_tpu/utils/wandb_.py``)."""

import os


__all__ = ["set_wandb_api_key"]


def set_wandb_api_key(api_key: str) -> None:
    """Set the WANDB_API_KEY environment variable."""
    os.environ["WANDB_API_KEY"] = api_key
