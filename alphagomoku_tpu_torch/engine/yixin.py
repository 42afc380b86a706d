"""YixinBoard GUI protocol.

Counterpart of the reference's YixinBoardProtocol
(reference: src/protocols/YixinBoardProtocol.cpp:49-623): extends the
Gomocup command set with the yx* command family used by the YixinBoard GUI
— board setup (yxboard), search control (yxstop, yxnbest), forbidden-move
display (yxshowforbid), hash management (yxhashclear/dump/load — no-op
acknowledgements here, the array tree has no persistent hash to dump),
swap2 negotiation (yxswap2), and info options (hash_size, caution_factor,
pondering, ...).  Database commands are acknowledged as unsupported, like
the reference's stubs (YixinBoardProtocol.cpp database stubs).  A copy of the reference
package's `engine/yixin.py`.
"""

from __future__ import annotations

from ..game.types import CROSS, CIRCLE, Move, invert_sign
from .gomocup import GomocupProtocol
from .protocol import (
    InputListener,
    Message,
    MessageQueue,
    MessageType,
    OutputSender,
)


class YixinBoardProtocol(GomocupProtocol):
    def __init__(self, input_queue: MessageQueue, output_queue: MessageQueue):
        super().__init__(input_queue, output_queue)
        # realtime analysis stream state (reference:
        # YixinBoardProtocol.cpp:714-795: REFRESH + POS/DONE on the first
        # info of a search, LOSE on newly proven losses, BEST on change)
        self.show_realtime_info = False
        self._rt_losing: set[tuple[int, int]] = set()
        self._rt_best: tuple[int, int] | None = None
        self.register_output(MessageType.REALTIME_INFO, self._out_realtime)
        for name, opt in (
            ("info max_depth", "max_depth"),
            ("info max_node", "max_nodes"),
            ("info time_increment", "time_increment"),
            ("info caution_factor", "style"),
            ("info pondering", "auto_pondering"),
            ("info thread_num", "threads"),
            ("info hash_size", "max_hash_size"),
            ("info nbest_sym", "nbest_sym"),
            ("info checkmate", "checkmate"),
            ("info thread_split_depth", "thread_split_depth"),
            # show_detail handled below: it also arms the realtime stream
            ("info usedatabase", "use_database"),
        ):
            self.register_input(name, self._make_info_option(name, opt))
        self.register_input("info show_detail", self._in_show_detail)
        self.register_input("yxboard", self._in_yxboard)
        self.register_input("yxstop", self._in_yxstop)
        self.register_input("yxshowforbid", self._in_yxshowforbid)
        self.register_input("yxbalance", self._in_yxbalance)
        self.register_input("yxnbest", self._in_yxnbest)
        self.register_input("yxhashclear", self._in_ok("yxhashclear"))
        self.register_input("yxhashdump", self._in_unsupported("yxhashdump"))
        self.register_input("yxhashload", self._in_unsupported("yxhashload"))
        self.register_input("yxshowhashusage", self._in_ok("yxshowhashusage"))
        self.register_input("yxswap2", self._in_yxswap2)
        self.register_input("yxdraw", self._in_ok("yxdraw"))
        self.register_input("yxresign", self._in_ok("yxresign"))
        self.register_input("yxshowinfo", self._in_yxshowinfo)
        for cmd in (
            "yxsoosorv",
            "yxprintfeature",
            "yxblockpathreset",
            "yxblockpathundo",
            "yxblockpath",
            "yxblockreset",
            "yxblockundo",
            "yxsearchdefend",
            "yxsetdatabase",
            "yxquerydatabaseall",
            "yxquerydatabaseone",
            "yxeditlabeldatabase",
            "yxedittvddatabase",
        ):
            self.register_input(cmd, self._in_unsupported(cmd))

    # -- helpers -----------------------------------------------------------

    def _in_ok(self, command: str):
        def fn(listener: InputListener) -> None:
            listener.consume_line()
            self.output_queue.push(Message(MessageType.INFO_MESSAGE, "OK"))

        return fn

    def _in_unsupported(self, command: str):
        def fn(listener: InputListener) -> None:
            listener.consume_line()
            self.output_queue.push(
                Message(MessageType.INFO_MESSAGE, f"{command} is not supported")
            )

        return fn

    # -- realtime analysis stream -------------------------------------------

    def _in_show_detail(self, listener: InputListener) -> None:
        value = self._extract_data(listener, "info show_detail")
        self.show_realtime_info = value.strip() == "1"
        self.input_queue.push(
            Message(MessageType.SET_OPTION, ("show_detail", value))
        )

    def _out_realtime(self, sender: OutputSender) -> None:
        """MESSAGE REALTIME REFRESH/POS/DONE/LOSE/BEST stream (reference:
        YixinBoardProtocol::process_realtime_info, :758-795)."""
        msg = self.output_queue.pop()
        snap = msg.data
        if not self.show_realtime_info or not snap:
            return
        fmt = lambda rc: f"{rc[0]},{rc[1]}"
        if snap.get("seq", 0) == 0:
            # new search: refresh the considered-move display
            self._rt_losing = set()
            self._rt_best = None
            sender.send("MESSAGE REALTIME REFRESH")
            for rc in snap["edges"]:
                sender.send("MESSAGE REALTIME POS " + fmt(tuple(rc)))
                sender.send("MESSAGE REALTIME DONE " + fmt(tuple(rc)))
        for rc in snap["losing"]:
            rc = tuple(rc)
            if rc not in self._rt_losing:
                sender.send("MESSAGE REALTIME LOSE " + fmt(rc))
                self._rt_losing.add(rc)
        best = tuple(snap["best"]) if snap.get("best") is not None else None
        if best is not None and best != self._rt_best:
            sender.send("MESSAGE REALTIME BEST " + fmt(best))
            self._rt_best = best

    # -- command handlers --------------------------------------------------

    def _in_yxboard(self, listener: InputListener) -> None:
        """Ordered stone list, 'done'-terminated; sets the position without
        searching (reference: YixinBoardProtocol yxboard)."""
        listener.consume_line()
        moves: list[Move] = []
        sign = CROSS
        while True:
            line = listener.get_line()
            if line.strip().lower() == "done":
                break
            parts = line.split(",")
            if len(parts) >= 3:
                field = int(parts[2])
                s = CROSS if field == 1 else CIRCLE
            else:
                s = sign
            m = self.move_from_string(",".join(parts[:2]), s)
            self._check_valid(m, moves)
            moves.append(m)
            sign = invert_sign(s)
        self.list_of_moves = moves
        self.input_queue.push(Message(MessageType.SET_POSITION, list(moves)))

    def _in_yxstop(self, listener: InputListener) -> None:
        listener.consume_line()
        self.input_queue.push(Message(MessageType.STOP_SEARCH))

    def _in_yxshowforbid(self, listener: InputListener) -> None:
        listener.consume_line()
        self.input_queue.push(
            Message(MessageType.SET_POSITION, list(self.list_of_moves))
        )
        self.input_queue.push(Message(MessageType.START_SEARCH, "showforbid"))

    def _in_yxbalance(self, listener: InputListener) -> None:
        data = self._extract_data(listener, "yxbalance")
        self.input_queue.push(
            Message(MessageType.SET_POSITION, list(self.list_of_moves))
        )
        self.input_queue.push(Message(MessageType.START_SEARCH, f"balance {data}"))

    def _in_yxnbest(self, listener: InputListener) -> None:
        self._extract_data(listener, "yxnbest")
        self.input_queue.push(
            Message(MessageType.SET_POSITION, list(self.list_of_moves))
        )
        self.input_queue.push(Message(MessageType.START_SEARCH, "bestmove"))

    def _in_yxswap2(self, listener: InputListener) -> None:
        listener.consume_line()
        self.input_queue.push(
            Message(MessageType.SET_POSITION, list(self.list_of_moves))
        )
        self.input_queue.push(Message(MessageType.START_SEARCH, "swap2"))

    def _in_yxshowinfo(self, listener: InputListener) -> None:
        listener.consume_line()
        self.output_queue.push(
            Message(MessageType.INFO_MESSAGE, "AlphaGomokuTPU engine")
        )
