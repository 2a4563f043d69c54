"""PB104: a wire declaration pointing at a qualname that is not an
``@tags.accounting`` method — the channel would cross unmetered."""
from repro_torch.analysis import tags


@tags.wire("up", accounted_by="Transport.launder", kind="embedding",
           reason="typo'd accounting target")
def declared_but_unmetered(adapter, params, e):  # PB104 (on the def)
    return adapter.server_loss(params["server"], e, None)
