"""The paper's own base experiment model (§VI-A-b).

Clients: single FC layer (feature_slice -> 128, ReLU).
Server: two FC layers (concat(clients) -> embed -> n_classes).
This config drives the tabular VFL experiments (Tables I/II, Figs 3-5a).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperMLPConfig:
    arch_id: str = "paper-mlp"
    n_features: int = 784            # MNIST-like flattened features
    n_classes: int = 10
    n_clients: int = 4
    client_embed: int = 128          # paper default client output size
    server_embed: int = 128          # paper sweeps {128, 256, 512}
    dtype: str = "float32"

    @property
    def features_per_client(self) -> int:
        return self.n_features // self.n_clients


CONFIG = PaperMLPConfig()
