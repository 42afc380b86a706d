"""Protocol base layer: async line input, message queues, command registries.

Python re-expression of the reference's protocol framework
(reference: include/alphagomoku/protocols/Protocol.hpp:25-165,
src/protocols/Protocol.cpp): `InputListener` (thread-fed line queue with
push/peek/consume used by both the live stdin reader and the protocol
tests), `OutputSender` (line sink), typed `Message`s carried by
`MessageQueue`s, and a `Protocol` base with input/output processor
registries dispatched by longest-prefix match.

A copy of the reference package's `engine/protocol.py` (host code, no
tensors).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import queue
import threading
from typing import Any, Callable, IO


class MessageType(enum.Enum):
    """(reference: Protocol.hpp MessageType)"""

    CHANGE_PROTOCOL = "change_protocol"
    START_PROGRAM = "start_program"
    SET_OPTION = "set_option"
    SET_POSITION = "set_position"
    START_SEARCH = "start_search"
    STOP_SEARCH = "stop_search"
    MAKE_MOVE = "make_move"
    EXIT_PROGRAM = "exit_program"
    EMPTY_MESSAGE = "empty"
    PLAIN_STRING = "plain_string"
    UNKNOWN_COMMAND = "unknown_command"
    ERROR = "error"
    INFO_MESSAGE = "info_message"
    ABOUT_ENGINE = "about_engine"
    BEST_MOVE = "best_move"
    REALTIME_INFO = "realtime_info"  # periodic root-edge snapshot during a
    # search (reference: YixinBoard REALTIME POS/DONE/LOSE/BEST stream,
    # YixinBoardProtocol.cpp:758-795); protocols without a processor drop it


@dataclasses.dataclass
class Message:
    type: MessageType
    data: Any = None  # str | (name, value) option | move | list of moves


class MessageQueue:
    """(reference: Protocol.hpp MessageQueue; deque + condvar so the output
    formatters can peek the head type before consuming)"""

    def __init__(self):
        self._dq: collections.deque[Message] = collections.deque()
        self._cv = threading.Condition()

    def push(self, msg: Message) -> None:
        with self._cv:
            self._dq.append(msg)
            self._cv.notify()

    def pop(self) -> Message:
        with self._cv:
            while not self._dq:
                self._cv.wait()
            return self._dq.popleft()

    def try_pop(self) -> Message | None:
        with self._cv:
            return self._dq.popleft() if self._dq else None

    def peek(self) -> Message | None:
        with self._cv:
            return self._dq[0] if self._dq else None

    def is_empty(self) -> bool:
        with self._cv:
            return not self._dq

    def length(self) -> int:
        with self._cv:
            return len(self._dq)


class InputListener:
    """Blocking line queue.  Live mode: a daemon thread pumps a stream into
    the queue; test mode: push_line feeds it directly
    (reference: Protocol.hpp:25-77, test fixture pattern in
    test/protocols/test_GomocupProtocol.cpp:14-35)."""

    def __init__(self, stream: IO[str] | None = None):
        self._q: queue.Queue[str] = queue.Queue()
        self._peeked: str | None = None
        self._eof = False
        if stream is not None:
            t = threading.Thread(target=self._pump, args=(stream,), daemon=True)
            t.start()

    def _pump(self, stream: IO[str]) -> None:
        for line in stream:
            self._q.put(line.rstrip("\r\n"))
        self._eof = True
        self._q.put("end")  # closed input stream shuts the engine down

    def push_line(self, line: str) -> None:
        self._q.put(line.rstrip("\r\n"))

    def get_line(self) -> str:
        if self._peeked is not None:
            line, self._peeked = self._peeked, None
            return line
        return self._q.get()

    def peek_line(self) -> str:
        if self._peeked is None:
            self._peeked = self._q.get()
        return self._peeked

    def consume_line(self) -> None:
        self.get_line()

    def is_empty(self) -> bool:
        return self._peeked is None and self._q.empty()


class OutputSender:
    def __init__(self, sink: Callable[[str], None]):
        self._sink = sink

    def send(self, line: str) -> None:
        self._sink(line)


class ProtocolRuntimeError(RuntimeError):
    pass


class Protocol:
    """Base protocol: registries + prefix dispatch
    (reference: src/protocols/Protocol.cpp processInput/processOutput)."""

    def __init__(self, input_queue: MessageQueue, output_queue: MessageQueue):
        self.input_queue = input_queue
        self.output_queue = output_queue
        self._input_processors: dict[str, Callable[[InputListener], None]] = {}
        self._output_processors: dict[MessageType, Callable[[OutputSender], None]] = {}

    def register_input(self, prefix: str, fn: Callable[[InputListener], None]) -> None:
        self._input_processors[prefix] = fn

    def register_output(
        self, mtype: MessageType, fn: Callable[[OutputSender], None]
    ) -> None:
        self._output_processors[mtype] = fn

    def process_input(self, listener: InputListener) -> None:
        """Dispatch one input line by longest matching registered prefix."""
        line = listener.peek_line().strip().lower()
        best = ""
        for prefix in self._input_processors:
            if line.startswith(prefix) and len(prefix) > len(best):
                best = prefix
        try:
            if best:
                self._input_processors[best](listener)
            else:
                listener.consume_line()
                self.output_queue.push(Message(MessageType.UNKNOWN_COMMAND, line))
        except ProtocolRuntimeError as e:
            self.output_queue.push(Message(MessageType.ERROR, str(e)))

    def process_output(self, sender: OutputSender) -> None:
        """Drain the output queue through the registered formatters."""
        while True:
            msg = self.output_queue.peek()
            if msg is None:
                return
            fn = self._output_processors.get(msg.type)
            if fn is None:
                self.output_queue.pop()  # drop unformattable message
            else:
                fn(sender)  # the formatter pops the message itself

    def reset(self) -> None:
        pass
