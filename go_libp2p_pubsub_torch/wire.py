"""Wire protocol: byte-compatible with the reference's JSON codec.

The reference frames every protocol interaction as one ``Message`` struct
serialized with Go's ``encoding/json`` over a libp2p stream
(``pubsub.go:122-153``).  Compatibility notes, each mirrored
here exactly so the live plane (net/live.py) can interoperate with a Go peer:

- ``MessageType``: Data=0, Join=1, Part=2, Update=3, State=4
  (``pubsub.go:138-144``).
- ``Type`` has no json tag -> always serialized as ``"Type"`` with an integer
  value, even when zero.
- ``Data []byte`` -> Go marshals byte slices as **base64** strings, json key
  ``"data"``, omitted when empty.
- ``Peers []string`` -> json key is ``"parents"`` (NOT "peers";
  ``pubsub.go:149``), omitted when empty.
- ``TreeWidth`` / ``TreeMaxWidth`` / ``NumPeers`` -> lowercase keys, omitted
  when zero (``omitempty``).
- Framing: concatenated JSON objects on the stream; Go's ``json.Encoder``
  appends ``\\n`` after each object and ``json.Decoder`` finds object
  boundaries itself (``pubsub.go:122-134``).  ``MessageDecoder`` below is the
  incremental equivalent.
"""

from __future__ import annotations

import base64
import codecs
import enum
import json
from dataclasses import dataclass, field
from typing import Iterator, List, Optional


class MessageType(enum.IntEnum):
    """Five-variant protocol message tag (reference ``pubsub.go:136-144``)."""

    DATA = 0
    JOIN = 1
    PART = 2
    UPDATE = 3
    STATE = 4


@dataclass
class Message:
    """The single message struct serving all five protocol purposes.

    Mirrors reference ``pubsub.go:146-153``.  Field semantics (``SURVEY.md``
    §2.2):

    - ``JOIN``   — first message on any new stream toward a prospective parent.
    - ``UPDATE`` — welcome (``peers == [senderID]`` plus fanout params) or
      redirect (``peers == [childID]``); receiver distinguishes by comparing
      ``peers`` against the sender (``subtree.go:283``).
    - ``STATE``  — child->parent accounting: ``num_peers`` subtree size plus
      grandchild id list.
    - ``PART``   — graceful leave notice.
    - ``DATA``   — application payload, root-originated.
    """

    type: MessageType = MessageType.DATA
    data: bytes = b""
    peers: List[str] = field(default_factory=list)
    tree_width: int = 0
    tree_max_width: int = 0
    num_peers: int = 0
    # Repair-replay marker (this build's extension, net/live.py): a Data
    # frame re-sent to a re-adopted orphan because the adopter cannot know
    # what the dead parent delivered.  On a Join it is a recovery request:
    # "replay me your retained forward-log window after admitting me".
    # Serialized only when set, so normal traffic stays byte-identical to
    # the reference encoder; a Go peer's ``encoding/json`` ignores the
    # unknown key on the frames that carry it.
    replay: bool = False
    # Failover extensions (net/live.py root-failover):
    # - ``epoch``: fencing counter; 0 (the whole pre-failover regime) is
    #   omitted on the wire so clean-path frames stay byte-identical to the
    #   reference encoder.  After a successor promotion every Data/Update
    #   frame carries the new epoch and receivers reject lower values.
    # - ``successors``: the root's rank-ordered successor list (its direct
    #   children in admission order), piggybacked on Update frames.
    # - ``roster``: the root's two-level membership view (direct children +
    #   reported grandchildren), the electorate a successor quorum-probes
    #   before promoting itself.
    epoch: int = 0
    successors: List[str] = field(default_factory=list)
    roster: List[str] = field(default_factory=list)
    # Distributed-tracing extensions (r19, obs/merge.py): the origin marks a
    # Data frame ``traced`` when its span ledger sampled the message, so
    # every downstream host stamps hop spans without re-negotiating the
    # sampling decision on the wire (the decision itself is recomputable
    # from the payload — the marker just spares untraced frames the hash).
    # ``clock_offset`` is the ORIGIN's host-clock offset estimate (seconds,
    # relative to the deployment's reference clock): receivers record it on
    # the recv stamp so the cross-host merge can normalize timestamps even
    # for hosts whose own estimate never reached the collector.  Both are
    # serialized only when set — untraced traffic stays byte-identical to
    # the reference encoder.
    traced: bool = False
    clock_offset: float = 0.0
    # In-memory span-key memo — NEVER serialized and excluded from
    # equality: hosts stamp a traced frame at several sites (recv, deliver,
    # forward) and the sha256 identity is the same at each, so the first
    # stamp caches it here for the rest of the frame's life on this host.
    span_key: Optional[str] = field(
        default=None, init=False, compare=False, repr=False)

    def to_json_obj(self) -> dict:
        # Field order matches the Go struct declaration order so encoded bytes
        # are identical to the reference encoder's output.
        obj: dict = {"Type": int(self.type)}
        if self.data:
            obj["data"] = base64.b64encode(self.data).decode("ascii")
        if self.peers:
            obj["parents"] = list(self.peers)
        if self.tree_width:
            obj["treewidth"] = self.tree_width
        if self.tree_max_width:
            obj["treemaxwidth"] = self.tree_max_width
        if self.num_peers:
            obj["numpeers"] = self.num_peers
        if self.replay:
            obj["replay"] = True
        if self.epoch:
            obj["epoch"] = self.epoch
        if self.successors:
            obj["successors"] = list(self.successors)
        if self.roster:
            obj["roster"] = list(self.roster)
        if self.traced:
            obj["traced"] = True
        if self.clock_offset:
            obj["clockoff"] = self.clock_offset
        return obj

    @classmethod
    def from_json_obj(cls, obj: dict) -> "Message":
        data = obj.get("data", "")
        return cls(
            type=MessageType(obj.get("Type", 0)),
            data=base64.b64decode(data) if data else b"",
            peers=list(obj.get("parents", []) or []),
            tree_width=int(obj.get("treewidth", 0)),
            tree_max_width=int(obj.get("treemaxwidth", 0)),
            num_peers=int(obj.get("numpeers", 0)),
            replay=bool(obj.get("replay", False)),
            epoch=int(obj.get("epoch", 0)),
            successors=list(obj.get("successors", []) or []),
            roster=list(obj.get("roster", []) or []),
            traced=bool(obj.get("traced", False)),
            clock_offset=float(obj.get("clockoff", 0.0)),
        )


def encode_message(m: Message) -> bytes:
    """Encode one message the way Go's ``json.Encoder.Encode`` does.

    Compact separators (Go emits no spaces) plus a trailing newline
    (``json.Encoder`` appends one after every value).
    """
    return json.dumps(m.to_json_obj(), separators=(",", ":")).encode() + b"\n"


def decode_message(buf: bytes) -> Message:
    """Decode exactly one message from ``buf`` (ignoring trailing bytes)."""
    obj, _ = json.JSONDecoder().raw_decode(buf.decode())
    return Message.from_json_obj(obj)


class MessageDecoder:
    """Incremental stream decoder: feed bytes, iterate complete messages.

    The equivalent of handing a ``json.Decoder`` the stream and letting it
    find object boundaries (``pubsub.go:126-134``): raw concatenated JSON
    objects, whitespace between objects tolerated.
    """

    def __init__(self) -> None:
        self._buf = ""
        self._dec = json.JSONDecoder()
        # Incremental UTF-8: a multi-byte rune split across socket reads must
        # buffer, not raise (Go emits non-ASCII peer ids as raw UTF-8).
        self._utf8 = codecs.getincrementaldecoder("utf-8")()

    def feed(self, data: bytes) -> None:
        self._buf += self._utf8.decode(data)

    def __iter__(self) -> Iterator[Message]:
        return self

    def __next__(self) -> Message:
        m = self.next_message()
        if m is None:
            raise StopIteration
        return m

    def next_message(self) -> Optional[Message]:
        s = self._buf.lstrip()
        if not s:
            self._buf = ""
            return None
        try:
            obj, end = self._dec.raw_decode(s)
        except json.JSONDecodeError:
            # Incomplete object: keep buffering.  A syntactically corrupt
            # stream surfaces as an ever-growing buffer; callers bound it.
            self._buf = s
            return None
        except RecursionError:
            # Pathological nesting (e.g. a "[[[[..." flood) blows the
            # scanner's stack long before any object completes.  Treat it
            # like an incomplete object: buffer, and let the caller's
            # pending-bytes bound abort the stream.
            self._buf = s
            return None
        self._buf = s[end:]
        return Message.from_json_obj(obj)

    def pending_bytes(self) -> int:
        return len(self._buf)
