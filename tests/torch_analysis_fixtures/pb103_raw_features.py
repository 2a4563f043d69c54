"""PB103: raw (pre-embedding) client features touched by server code.
The client-party twin touching the same name stays legal."""
from repro_torch.analysis import tags


@tags.party("server")
def server_backbone(params, x_parts, y):
    return _backbone(params, x_parts)  # PB103: raw features on the server


@tags.party("client")
def client_projection(params, x_parts):
    return _embed(params, x_parts)  # quiet: clients own their features


def _backbone(params, x):
    return x


def _embed(params, x):
    return x
