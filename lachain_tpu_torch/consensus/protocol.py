"""Protocol actor base + broadcaster interface.

The port of `lachain_tpu/consensus/protocol.py` (:27-200). A protocol is a
plain object whose `receive(envelope)` runs to completion; ordering lives
in the router (era.py) and the delivery layer (simulator.py), so a
consensus execution is deterministic and replays from a seed.

An exception inside `receive` terminates the protocol instance (logged);
the router drops further traffic to it. Work that runs outside `receive`
(a batcher's flush and the callbacks it fans out) raises to its caller.

Differences, by the port's rules: the broadcaster carries the crypto
`backend` (its `host` property the host ops: pairings, hash-to-curve,
point checks and the small MSMs) and the router's random generator `rng`,
where the reference reads a global provider and draws from `secrets`; the
reference's metrics, tracing spans and watchdog breadcrumbs are not
carried over.
"""
from __future__ import annotations

import logging
from typing import Any, Optional

from . import messages as M

logger = logging.getLogger("lachain_tpu_torch.consensus")


class Broadcaster:
    """What a protocol needs from its environment."""

    @property
    def my_id(self) -> int:
        raise NotImplementedError

    @property
    def n_validators(self) -> int:
        raise NotImplementedError

    @property
    def f(self) -> int:
        raise NotImplementedError

    def broadcast(self, payload) -> None:
        """Send an external payload to every validator (including self)."""
        raise NotImplementedError

    def send_to(self, validator: int, payload) -> None:
        raise NotImplementedError

    def internal_request(self, req: "M.Request") -> None:
        """Route a Request to the target protocol (creating it if needed)."""
        raise NotImplementedError

    def internal_response(self, res: "M.Result") -> None:
        """Route a protocol's Result to its parent."""
        raise NotImplementedError


class Protocol:
    """Base class for consensus protocol instances."""

    def __init__(self, pid, broadcaster: Broadcaster):
        self.id = pid
        self.broadcaster = broadcaster
        self.terminated = False
        self.result: Any = None
        self._result_emitted = False
        self._parent: Optional[Any] = None

    # -- runtime ------------------------------------------------------------
    def receive(self, envelope) -> None:
        """Process one envelope to completion. An exception terminates the
        protocol."""
        if self.terminated:
            return
        try:
            if isinstance(envelope, M.External):
                self.handle_external(envelope.sender, envelope.payload)
            elif isinstance(envelope, M.Request):
                self._parent = envelope.from_id
                if self._result_emitted:
                    # completed before the parent asked (instance was created
                    # by external traffic): replay the result to the parent
                    self.broadcaster.internal_response(
                        M.Result(
                            from_id=self.id,
                            to_id=self._parent,
                            value=self.result,
                        )
                    )
                else:
                    self.handle_input(envelope.input)
            elif isinstance(envelope, M.Result):
                self.handle_child_result(envelope.from_id, envelope.value)
            else:
                raise TypeError(f"bad envelope {type(envelope)}")
        except Exception:
            logger.exception("protocol %s terminated by exception", self.id)
            self.terminated = True

    def emit_result(self, value) -> None:
        """Report the protocol's output to the parent, once."""
        if self._result_emitted:
            return
        self._result_emitted = True
        self.result = value
        self.broadcaster.internal_response(
            M.Result(from_id=self.id, to_id=self._parent, value=value)
        )

    # -- to override --------------------------------------------------------
    def handle_input(self, value) -> None:
        raise NotImplementedError

    def handle_external(self, sender: int, payload) -> None:
        raise NotImplementedError

    def handle_child_result(self, child_id, value) -> None:
        pass

    # -- helpers ------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.broadcaster.n_validators

    @property
    def f(self) -> int:
        return self.broadcaster.f

    @property
    def me(self) -> int:
        return self.broadcaster.my_id

    @property
    def host(self):
        """The host backend of the broadcaster's crypto backend: a
        GpuBackend's `host`, or the backend itself where it is a host
        backend."""
        backend = self.broadcaster.backend
        return getattr(backend, "host", backend)

    def request(self, to_id, value) -> None:
        self.broadcaster.internal_request(
            M.Request(from_id=self.id, to_id=to_id, input=value)
        )
