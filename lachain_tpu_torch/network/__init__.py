"""The network layer of the port: the seeded fault plans (`faults.py`)
that the consensus simulators execute, and the consensus payload codec
(`wire.py`) that the send journal records."""
from .wire import decode_payload, encode_payload

__all__ = ["decode_payload", "encode_payload"]
