from repro_torch.data.synthetic import make_classification, vertical_partition

__all__ = ["make_classification", "vertical_partition"]
