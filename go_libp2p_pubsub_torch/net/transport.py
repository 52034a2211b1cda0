"""Live transport plane: asyncio TCP streams with protocol-id routing.

This is the DCN-side communication backend (SURVEY.md §5.8): the structural
equivalent of the vendored libp2p host the reference builds on —
``host.Host`` / ``net.Stream`` / ``h.NewStream`` / ``h.SetStreamHandler``
(``pubsub.go:10-13,74``, ``subtree.go:257``) — rebuilt on
asyncio TCP so host processes can interoperate over real sockets while the
device-resident sim plane (``ops/``, ``parallel/``) rides ICI.

Mapping:

- ``host.Host``              -> :class:`LiveHost` (one TCP listener per host)
- ``peer.ID``                -> string host id, resolved via :class:`Peerstore`
- ``protocol.ID`` routing    -> one-line JSON handshake ``{"proto":..,"peer":..}``
  sent by the dialer; the acceptor dispatches to the handler registered for
  that protocol id (``h.SetStreamHandler``, ``pubsub.go:74``, ``client.go:85``)
- ``net.Stream``             -> :class:`Stream`: one TCP connection per stream,
  carrying concatenated JSON wire messages (:mod:`..wire`)

The reference multiplexes streams over one connection via libp2p's muxer; a
connection-per-stream keeps the transport dependency-free, and stream counts
here are O(tree edges), not O(messages).
"""

from __future__ import annotations

import asyncio
import json
from typing import Awaitable, Callable, Dict, Optional, Tuple

from ..wire import Message, MessageDecoder, encode_message

StreamHandler = Callable[["Stream"], Awaitable[None]]

# Upper bound on buffered undecoded bytes before the stream is declared
# corrupt (the reference relies on json.Decoder erroring; a pure buffer needs
# an explicit bound).
MAX_PENDING_BYTES = 1 << 20


class StreamClosed(Exception):
    """Read/write on a closed or failed stream — the analog of the io errors
    ``processMessages`` / ``forwardMessage`` key their failure detection on
    (``client.go:105``, ``subtree.go:334``)."""


class Peerstore:
    """host id -> dial address registry (go-libp2p-peerstore analog).

    The reference tests full-mesh ``Connect`` all hosts so later redirect
    dials succeed (``pubsub_test.go:37-57``); registering addresses here is
    the same precondition.
    """

    def __init__(self, validate_ids: bool = False) -> None:
        # ``validate_ids=True`` is the reference's regime: peer ids must be
        # well-formed base58 multihashes (``translPeerIDs``,
        # ``subtree.go:228-239``) and wire-carried candidate lists are
        # filtered through ``utils.base58.transl_peer_ids`` before dialing.
        # The default keeps ids opaque strings (sim/test convenience).
        self._addrs: Dict[str, Tuple[str, int]] = {}
        self.validate_ids = validate_ids

    def add(self, peer_id: str, host: str, port: int) -> None:
        if self.validate_ids:
            from ..utils.base58 import parse_peer_id

            parse_peer_id(peer_id)  # raises ValueError on malformed ids
        self._addrs[peer_id] = (host, port)

    def addr(self, peer_id: str) -> Tuple[str, int]:
        try:
            return self._addrs[peer_id]
        except KeyError:
            # Name who IS registered (capped at 10): a failed redirect dial
            # is usually a peerstore wiring bug, and the candidate list makes
            # it diagnosable from the message alone.
            known = sorted(self._addrs)
            shown = ", ".join(repr(p) for p in known[:10])
            if len(known) > 10:
                shown += f", ... +{len(known) - 10} more"
            raise KeyError(
                f"no address registered for peer {peer_id!r}; "
                f"known peers: [{shown}]"
            ) from None

    def known(self) -> Dict[str, Tuple[str, int]]:
        return dict(self._addrs)


class Stream:
    """One bidirectional wire-message stream (``net.Stream`` analog)."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        remote_peer: str,
        protoid: str,
        on_close: Optional[Callable[["Stream"], None]] = None,
    ) -> None:
        self._reader = reader
        self._writer = writer
        self._decoder = MessageDecoder()
        self.remote_peer = remote_peer  # s.Conn().RemotePeer() (subtree.go:140)
        self.protoid = protoid
        self._closed = False
        self._on_close = on_close

    def _notify_close(self) -> None:
        if self._on_close is not None:
            self._on_close(self)
            self._on_close = None

    async def write_message(self, m: Message) -> None:
        """``writeMessage`` (``pubsub.go:122-125``): one encoded JSON object."""
        if self._closed:
            raise StreamClosed("write on closed stream")
        try:
            self._writer.write(encode_message(m))
            await self._writer.drain()
        except (ConnectionError, RuntimeError, OSError) as e:
            self._closed = True
            self._notify_close()
            raise StreamClosed(str(e)) from e

    async def read_message(self) -> Message:
        """``readMessage`` (``pubsub.go:127-134``): next JSON object, however
        the bytes were chunked on the socket."""
        while True:
            m = self._decoder.next_message()
            if m is not None:
                return m
            if self._decoder.pending_bytes() > MAX_PENDING_BYTES:
                self.abort()
                raise StreamClosed("oversized/corrupt message on stream")
            if self._closed:
                raise StreamClosed("read on closed stream")
            try:
                data = await self._reader.read(65536)
            except (ConnectionError, OSError) as e:
                self._closed = True
                self._notify_close()
                raise StreamClosed(str(e)) from e
            if not data:
                self._closed = True
                self._notify_close()
                raise StreamClosed("EOF")
            try:
                self._decoder.feed(data)
            except UnicodeDecodeError as e:
                # Genuinely invalid UTF-8 on the wire (split runes are handled
                # by the decoder's incremental buffering).
                self.abort()
                raise StreamClosed(f"invalid UTF-8 on stream: {e}") from e

    def close(self) -> None:
        """Graceful close (FIN): the remote's pending reads still drain."""
        if not self._closed:
            self._closed = True
            try:
                self._writer.close()
            except Exception:
                pass
        self._notify_close()

    def abort(self) -> None:
        """Abrupt teardown (RST-ish): the abrupt-kill fault of the dropping
        tests (``pubsub_test.go:178,252``)."""
        if not self._closed:
            self._closed = True
            try:
                self._writer.transport.abort()
            except Exception:
                pass
        self._notify_close()

    @property
    def closed(self) -> bool:
        return self._closed


class LiveHost:
    """A live peer process endpoint (``host.Host`` analog).

    Owns one TCP listener; inbound connections carry a one-line JSON
    handshake naming the dialer and the protocol id, then become
    :class:`Stream` objects dispatched to the registered handler — the
    transport-level mirror of libp2p's per-protocol stream routing.
    """

    def __init__(
        self,
        peer_id: str,
        peerstore: Peerstore,
        bind: str = "127.0.0.1",
        chaos=None,
    ):
        self.id = peer_id
        self.peerstore = peerstore
        # Optional fault injector (net/chaos.ChaosTransport): None keeps
        # every stream un-wrapped — the clean path has zero chaos cost.
        self.chaos = chaos
        self._bind = bind
        self._server: Optional[asyncio.AbstractServer] = None
        self._handlers: Dict[str, StreamHandler] = {}
        self._tasks: set = set()
        self._streams: set = set()
        self.closed = False

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._accept, self._bind, 0)
        port = self._server.sockets[0].getsockname()[1]
        self.peerstore.add(self.id, self._bind, port)

    async def aclose(self, graceful: bool = True) -> None:
        """Tear the host down.

        ``graceful=False`` is the abrupt ``hosts[i].Close()`` kill: every open
        stream is aborted so remotes see hard errors, no Part flows.
        """
        self.closed = True
        if self._server is not None:
            self._server.close()
        for s in list(self._streams):
            if graceful:
                s.close()
            else:
                s.abort()
        for t in list(self._tasks):
            t.cancel()

    # -- streams -------------------------------------------------------------

    def set_stream_handler(self, protoid: str, fn: StreamHandler) -> None:
        """``h.SetStreamHandler`` (``pubsub.go:74``, ``client.go:85``)."""
        self._handlers[protoid] = fn

    def remove_stream_handler(self, protoid: str) -> None:
        """``h.RemoveStreamHandler`` (``pubsub.go:100``, ``client.go:32``)."""
        self._handlers.pop(protoid, None)

    async def new_stream(self, peer_id: str, protoid: str) -> Stream:
        """Dial a peer for a protocol (``h.NewStream``, ``subtree.go:257``)."""
        if self.closed:
            raise StreamClosed(f"host {self.id} is closed")
        if self.chaos is not None and not self.chaos.allow_dial(
            self.id, peer_id, protoid
        ):
            raise StreamClosed(f"dial {peer_id} blackholed (chaos)")
        host, port = self.peerstore.addr(peer_id)
        try:
            reader, writer = await asyncio.open_connection(host, port)
            writer.write(
                (json.dumps({"proto": protoid, "peer": self.id}) + "\n").encode()
            )
            await writer.drain()
        except (ConnectionError, OSError) as e:
            raise StreamClosed(f"dial {peer_id} failed: {e}") from e
        s = Stream(
            reader, writer, remote_peer=peer_id, protoid=protoid,
            on_close=self._streams.discard,
        )
        self._streams.add(s)
        if self.chaos is not None:
            return self.chaos.wrap(s, self.id, spawn=self.spawn)
        return s

    def spawn(self, coro) -> asyncio.Task:
        """Track a protocol task for teardown (goroutine-spawn analog)."""
        t = asyncio.ensure_future(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)
        return t

    async def _accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        if self.closed:
            writer.transport.abort()
            return
        try:
            line = await reader.readline()
            hs = json.loads(line)
            protoid, remote = hs["proto"], hs["peer"]
            if self.peerstore.validate_ids:
                # Strict-id regime: the accept boundary is where adversarial
                # ids arrive; a malformed claimed id would be admitted as a
                # child but unreachable via redirects (validating joiners
                # filter it from candidate lists) — refuse it outright.
                from ..utils.base58 import parse_peer_id

                parse_peer_id(remote)
        except Exception:
            writer.close()
            return
        handler = self._handlers.get(protoid)
        if handler is None:
            # No protocol registered (topic closed/unknown): refuse.
            writer.close()
            return
        s = Stream(
            reader, writer, remote_peer=remote, protoid=protoid,
            on_close=self._streams.discard,
        )
        self._streams.add(s)
        if self.chaos is not None:
            # Egress faults are symmetric: the acceptor's writes back to the
            # dialer run under the (acceptor, dialer, proto) link policy.
            self.spawn(handler(self.chaos.wrap(s, self.id, spawn=self.spawn)))
            return
        self.spawn(handler(s))
