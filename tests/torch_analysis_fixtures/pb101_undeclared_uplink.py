"""PB101: client-sourced value reaches a server sink with no declared wire."""


def train_step(adapter, params, batch):
    e = adapter.client_embed(params["clients"], batch)
    return adapter.server_loss(params["server"], e, batch)  # PB101
