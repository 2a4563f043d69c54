"""Suppression mechanics: a justified ignore silences its finding; an
unjustified one is BA001 AND the original finding survives."""


def justified(adapter, params, batch):
    e = adapter.client_embed(params["clients"], batch)
    # analysis: ignore[PB101] fixture: documented test-only crossing
    return adapter.server_loss(params["server"], e, batch)  # quiet


def unjustified(adapter, params, batch):
    e = adapter.client_embed(params["clients"], batch)
    # analysis: ignore[PB101]
    return adapter.server_loss(params["server"], e, batch)  # PB101 + BA001
