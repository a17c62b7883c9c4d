"""The port's models."""

from multimodal_segmentation_project_tpu_torch.models.discriminator import DomainDiscriminator
from multimodal_segmentation_project_tpu_torch.models.unet3d import DoubleConv, UNet3D

__all__ = ["DomainDiscriminator", "DoubleConv", "UNet3D"]
