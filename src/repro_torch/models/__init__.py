"""Models of the port: the paper's tabular MLP and parameter machinery."""
