"""The corpus' accounting target: `Transport.account` is the one legal
``accounted_by`` qualname inside this fixture set (mirrors the real
``repro_torch.federation.transport.Transport``)."""
from repro_torch.analysis import tags


class Transport:
    @tags.accounting
    def account(self, message):
        return message
