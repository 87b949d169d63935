"""The paper's own evaluation models (Sec. 5): an MLP with one hidden layer
of 30 units for MNIST-like data, and a VGG-style CNN for BIRD-like data.
The configs carry the paper's published hyperparameters;
:mod:`repro_torch.models.simple` builds the models."""
from dataclasses import dataclass


@dataclass(frozen=True)
class MLPConfig:
    name: str = "paper-mlp"
    input_dim: int = 784            # 28x28x1 MNIST
    hidden: int = 30                # paper: "one hidden layer with 30 units"
    num_classes: int = 10
    learning_rate: float = 1e-4     # paper Sec. 5.4.1
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-7
    batch_size: int = 32
    train_per_node: int = 320       # paper: 320 train / 80 test per station
    test_per_node: int = 80


@dataclass(frozen=True)
class VGGConfig:
    name: str = "paper-vgg"
    image_size: int = 32            # reduced from 224 (CPU repro; same family)
    channels: int = 3
    num_classes: int = 5            # paper: 5 categories per base station
    stages: tuple = (16, 32, 64)    # conv widths (VGG-style doubled stages)
    learning_rate: float = 1e-3     # paper Sec. 5.4.2
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-7
    batch_size: int = 10
    train_per_node: int = 120       # paper: 120 train / 30 test per station
    test_per_node: int = 30


MLP_CONFIG = MLPConfig()
VGG_CONFIG = VGGConfig()
