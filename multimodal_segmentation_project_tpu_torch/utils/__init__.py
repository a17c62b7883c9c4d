"""Experiment bookkeeping and end-of-run plots for the port's trainer
(``plot_training_metrics`` imports matplotlib when it is called)."""

from multimodal_segmentation_project_tpu_torch.utils.experiment import (
    ExperimentPaths,
    create_experiment_name,
    format_time,
    log_device_usage,
    write_config,
)
from multimodal_segmentation_project_tpu_torch.utils.plotting import plot_training_metrics

__all__ = [
    "ExperimentPaths",
    "create_experiment_name",
    "format_time",
    "write_config",
    "log_device_usage",
    "plot_training_metrics",
]
