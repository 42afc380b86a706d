"""Gomocup tournament protocol + extended variant.

Faithful re-expression of the reference's protocol behavior
(reference: src/protocols/GomocupProtocol.cpp:48-505,
src/protocols/ExtendedGomocupProtocol.cpp:25-302): same command set, same
move text format "row,col" (optionally transposed), same BOARD stone-list
reconstruction (own/opponent lists interleaved by count parity), same INFO
option routing into SET_OPTION messages, same OK/ERROR/UNKNOWN/MESSAGE/
SUGGEST output framing.  A copy of the reference package's
`engine/gomocup.py`: its lines, the ABOUT line included, are the reference
package's, line for line.
"""

from __future__ import annotations

from ..game.types import CROSS, CIRCLE, Move, invert_sign, GameRules
from .protocol import (
    InputListener,
    Message,
    MessageQueue,
    MessageType,
    OutputSender,
    Protocol,
    ProtocolRuntimeError,
)


class GomocupProtocol(Protocol):
    def __init__(self, input_queue: MessageQueue, output_queue: MessageQueue):
        super().__init__(input_queue, output_queue)
        self.rows = 0
        self.columns = 0
        self.transpose_coords = False
        self.list_of_moves: list[Move] = []

        self.register_output(MessageType.BEST_MOVE, self._out_best_move)
        self.register_output(MessageType.PLAIN_STRING, self._out_plain)
        self.register_output(MessageType.UNKNOWN_COMMAND, self._out_unknown)
        self.register_output(MessageType.ERROR, self._out_error)
        self.register_output(MessageType.INFO_MESSAGE, self._out_info)
        self.register_output(MessageType.ABOUT_ENGINE, self._out_about)

        for name, value_opt in (
            ("info timeout_turn", "time_for_turn"),
            ("info timeout_match", "time_for_match"),
            ("info time_left", "time_left"),
            ("info max_memory", "max_memory"),
            ("info folder", "folder"),
        ):
            self.register_input(name, self._make_info_option(name, value_opt))
        self.register_input("info game_type", lambda l: l.consume_line())
        self.register_input("info evaluate", self._in_evaluate)
        self.register_input("info rule", self._in_rule)
        self.register_input("start", self._in_start)
        self.register_input("rectstart", self._in_rectstart)
        self.register_input("restart", self._in_restart)
        self.register_input("begin", self._in_begin)
        self.register_input("board", self._in_board)
        self.register_input("turn", self._in_turn)
        self.register_input("takeback", self._in_takeback)
        self.register_input("end", self._in_end)
        self.register_input("about", self._in_about)

    def reset(self) -> None:
        self.list_of_moves = []

    # ---- helpers ---------------------------------------------------------

    def move_to_string(self, m: Move) -> str:
        if self.transpose_coords:
            return f"{m.col},{m.row}"
        return f"{m.row},{m.col}"

    def move_from_string(self, s: str, sign: int) -> Move:
        parts = s.split(",")
        if len(parts) < 2:
            raise ProtocolRuntimeError(f"Incorrect move '{s}' was passed")
        row, col = int(parts[0]), int(parts[1])
        if not (0 <= row < 128 and 0 <= col < 128):
            raise ProtocolRuntimeError(f"Invalid move '{s}'")
        if self.transpose_coords:
            row, col = col, row
        return Move(row=row, col=col, sign=sign)

    def _extract_data(self, listener: InputListener, command: str) -> str:
        line = listener.get_line()
        return line[len(command) :].strip()

    def _sign_to_move(self) -> int:
        if not self.list_of_moves:
            return CROSS
        return invert_sign(self.list_of_moves[-1].sign)

    def _check_valid(self, m: Move, played: list[Move]) -> None:
        if not (0 <= m.row < self.rows and 0 <= m.col < self.columns):
            raise ProtocolRuntimeError(
                f"Move {self.move_to_string(m)} is outside of "
                f"{self.rows}x{self.columns} board"
            )
        for p in played:
            if p.row == m.row and p.col == m.col:
                raise ProtocolRuntimeError(
                    f"Spot {self.move_to_string(m)} is already occupied"
                )

    def _set_position_and_search(self) -> None:
        self.input_queue.push(
            Message(MessageType.SET_POSITION, list(self.list_of_moves))
        )
        self.input_queue.push(Message(MessageType.START_SEARCH, "bestmove"))

    # ---- output processors ----------------------------------------------

    def _out_best_move(self, sender: OutputSender) -> None:
        msg = self.output_queue.pop()
        if isinstance(msg.data, Move):
            sender.send(self.move_to_string(msg.data))
            self.list_of_moves.append(msg.data)
        elif isinstance(msg.data, list):
            # multiple moves, e.g. a swap2 two-stone balancing answer
            # (reference: ExtendedGomocupProtocol::best_move
            # holdsListOfMoves leg, ExtendedGomocupProtocol.cpp:88-99)
            sender.send(" ".join(self.move_to_string(m) for m in msg.data))
            self.list_of_moves.extend(msg.data)

    def _out_plain(self, sender: OutputSender) -> None:
        sender.send(str(self.output_queue.pop().data))

    def _out_unknown(self, sender: OutputSender) -> None:
        sender.send(f"UNKNOWN '{self.output_queue.pop().data}'")

    def _out_error(self, sender: OutputSender) -> None:
        sender.send(f"ERROR {self.output_queue.pop().data}")

    def _out_info(self, sender: OutputSender) -> None:
        sender.send(f"MESSAGE {self.output_queue.pop().data}")

    def _out_about(self, sender: OutputSender) -> None:
        sender.send(str(self.output_queue.pop().data))

    # ---- input processors -----------------------------------------------

    def _make_info_option(self, command: str, option: str):
        def fn(listener: InputListener) -> None:
            value = self._extract_data(listener, command)
            self.input_queue.push(Message(MessageType.SET_OPTION, (option, value)))

        return fn

    def _in_evaluate(self, listener: InputListener) -> None:
        """Per-move evaluation query answered from the last search's root
        edges (reference: GomocupProtocol::info_evaluate,
        GomocupProtocol.cpp:347-361)."""
        data = self._extract_data(listener, "info evaluate")
        self.input_queue.push(
            Message(MessageType.START_SEARCH, f"evaluate {data.strip()}")
        )

    def _in_rule(self, listener: InputListener) -> None:
        """(reference: GomocupProtocol.cpp:320-346 rule numbers)"""
        data = self._extract_data(listener, "info rule")
        mapping = {
            0: GameRules.FREESTYLE,
            1: GameRules.STANDARD,
            4: GameRules.RENJU,
            8: GameRules.CARO6,
            9: GameRules.CARO5,
        }
        v = int(data)
        if v == 2:
            self.output_queue.push(
                Message(MessageType.ERROR, "Continuous game is not supported")
            )
        elif v in mapping:
            self.input_queue.push(
                Message(MessageType.SET_OPTION, ("rules", str(mapping[v])))
            )
        else:
            self.output_queue.push(Message(MessageType.ERROR, f"Invalid rule {data}"))

    def _in_start(self, listener: InputListener) -> None:
        parts = listener.get_line().split()
        if len(parts) != 2:
            raise ProtocolRuntimeError(f"Incorrect command '{' '.join(parts)}'")
        size = int(parts[1])
        self.input_queue.push(Message(MessageType.START_PROGRAM))
        self.input_queue.push(Message(MessageType.SET_OPTION, ("rows", str(size))))
        self.input_queue.push(Message(MessageType.SET_OPTION, ("columns", str(size))))
        self.input_queue.push(
            Message(MessageType.SET_OPTION, ("draw_after", str(size * size)))
        )
        if size in (15, 20):
            self.rows = self.columns = size
            self.output_queue.push(Message(MessageType.PLAIN_STRING, "OK"))
        else:
            self.output_queue.push(
                Message(MessageType.ERROR, "Only 15x15 or 20x20 boards are supported")
            )

    def _in_rectstart(self, listener: InputListener) -> None:
        line = listener.get_line()
        parts = line.split()
        if len(parts) != 2 or "," not in parts[1]:
            raise ProtocolRuntimeError(f"Incorrect command '{line}' was passed")
        c, r = parts[1].split(",")[:2]
        if int(r) != int(c):
            self.output_queue.push(
                Message(MessageType.ERROR, "Rectangular boards are not supported")
            )
            return
        size = int(r)
        if size in (15, 20):
            self.rows = self.columns = size
            self.input_queue.push(Message(MessageType.SET_OPTION, ("rows", str(size))))
            self.input_queue.push(
                Message(MessageType.SET_OPTION, ("columns", str(size)))
            )
            self.input_queue.push(
                Message(MessageType.SET_OPTION, ("draw_after", str(size * size)))
            )
            self.input_queue.push(Message(MessageType.START_PROGRAM))
            self.output_queue.push(Message(MessageType.PLAIN_STRING, "OK"))
        else:
            self.output_queue.push(
                Message(MessageType.ERROR, "Only 15x15 or 20x20 boards are supported")
            )

    def _in_restart(self, listener: InputListener) -> None:
        listener.consume_line()
        self.list_of_moves = []
        self.output_queue.push(Message(MessageType.PLAIN_STRING, "OK"))

    def _in_begin(self, listener: InputListener) -> None:
        listener.consume_line()
        self.list_of_moves = []
        self._set_position_and_search()

    def _in_board(self, listener: InputListener) -> None:
        """Stone list with 1=own / 2=opponent markers, 'done'-terminated
        (reference: GomocupProtocol.cpp:172-235 parse_list_of_moves)."""
        listener.consume_line()
        own: list[Move] = []
        opp: list[Move] = []
        while True:
            line = listener.get_line()
            if line.strip().lower() == "done":
                break
            parts = line.split(",")
            if len(parts) != 3:
                raise ProtocolRuntimeError(f"Incorrect command '{line}' was passed")
            m = self.move_from_string(line, 0)
            self._check_valid(m, own)
            self._check_valid(m, opp)
            field = int(parts[2])
            if field == 1:
                own.append(m)
            elif field == 2:
                opp.append(m)
            # 3 = continuous game, not supported: ignored
        if len(own) == len(opp):  # engine plays cross
            own = [m._replace(sign=CROSS) for m in own]
            opp = [m._replace(sign=CIRCLE) for m in opp]
        elif len(own) + 1 == len(opp):  # opponent started as cross
            own = [m._replace(sign=CIRCLE) for m in own]
            opp = [m._replace(sign=CROSS) for m in opp]
        else:
            raise ProtocolRuntimeError(
                "Invalid position - too many stones of either color"
            )
        moves: list[Move] = []
        if len(own) != len(opp):
            moves.append(opp.pop(0))
        for a, b in zip(own, opp):
            moves.append(a)
            moves.append(b)
        self.list_of_moves = moves
        self._set_position_and_search()

    def _in_turn(self, listener: InputListener) -> None:
        data = self._extract_data(listener, "turn")
        m = self.move_from_string(data, self._sign_to_move())
        self._check_valid(m, self.list_of_moves)
        self.list_of_moves.append(m)
        self._set_position_and_search()

    def _in_takeback(self, listener: InputListener) -> None:
        data = self._extract_data(listener, "takeback")
        m = self.move_from_string(data, 0)
        if (
            self.list_of_moves
            and self.list_of_moves[-1].row == m.row
            and self.list_of_moves[-1].col == m.col
        ):
            self.list_of_moves.pop()
            self.output_queue.push(Message(MessageType.PLAIN_STRING, "OK"))
        else:
            self.output_queue.push(
                Message(MessageType.ERROR, "Takeback of a non-last move")
            )

    def _in_end(self, listener: InputListener) -> None:
        listener.consume_line()
        self.input_queue.push(Message(MessageType.EXIT_PROGRAM))

    def _in_about(self, listener: InputListener) -> None:
        listener.consume_line()
        self.input_queue.push(Message(MessageType.START_PROGRAM))
        self.output_queue.push(
            Message(
                MessageType.ABOUT_ENGINE,
                'name="AlphaGomokuTPU", version="0.1", '
                'author="alphagomoku_tpu", country="-"',
            )
        )


class ExtendedGomocupProtocol(GomocupProtocol):
    """(reference: src/protocols/ExtendedGomocupProtocol.cpp:25-302)"""

    def __init__(self, input_queue: MessageQueue, output_queue: MessageQueue):
        super().__init__(input_queue, output_queue)
        self.analysis_mode = False
        for name, opt in (
            ("info analysis_mode", "analysis_mode"),
            ("info max_depth", "max_depth"),
            ("info max_node", "max_nodes"),
            ("info time_increment", "time_increment"),
            ("info style", "style"),
            ("info auto_pondering", "auto_pondering"),
            ("info protocol_lag", "protocol_lag"),
            ("info thread_num", "threads"),
            # extension: the reference loads the swap2 book only from
            # config.json (EngineSettings.cpp:75); exposing it over INFO
            # lets tournament managers configure it at runtime too
            ("info swap2_openings_file", "swap2_openings_file"),
        ):
            self.register_input(name, self._make_info_option(name, opt))
        self.register_input("play", self._in_play)
        self.register_input("ponder", self._in_ponder)
        self.register_input("stop", self._in_stop)
        self.register_input("showforbid", self._in_showforbid)
        self.register_input("balance", self._in_balance)
        self.register_input("clearhash", self._in_clearhash)
        self.register_input("protocolversion", self._in_protocolversion)
        self.register_input("proboard", self._in_proboard)
        self.register_input("longproboard", self._in_proboard)
        self.register_input("swapboard", self._in_swapboard)
        self.register_input("swap2board", self._in_swap2board)
        self.register_input("swap5board", self._make_swapx("swap5"))
        self.register_input("swap1stboard", self._make_swapx("swap1st"))
        # overrides the generic option forwarding registered above
        self.register_input("info analysis_mode", self._in_analysis_mode)

    def _in_analysis_mode(self, listener: InputListener) -> None:
        value = self._extract_data(listener, "info analysis_mode")
        self.analysis_mode = value.strip() not in ("0", "false", "")
        self.input_queue.push(
            Message(MessageType.SET_OPTION, ("analysis_mode", value))
        )

    def _out_best_move(self, sender: OutputSender) -> None:
        """Analysis mode answers SUGGEST without playing the move
        (reference: ExtendedGomocupProtocol.cpp:74-87)."""
        if not self.analysis_mode:
            super()._out_best_move(sender)
            return
        msg = self.output_queue.pop()
        if isinstance(msg.data, Move):
            sender.send(f"SUGGEST {self.move_to_string(msg.data)}")

    def _in_play(self, listener: InputListener) -> None:
        """Forced move: play without searching."""
        data = self._extract_data(listener, "play")
        m = self.move_from_string(data, self._sign_to_move())
        self._check_valid(m, self.list_of_moves)
        self.list_of_moves.append(m)
        self.input_queue.push(
            Message(MessageType.SET_POSITION, list(self.list_of_moves))
        )
        self.output_queue.push(Message(MessageType.PLAIN_STRING, self.move_to_string(m)))

    def _in_ponder(self, listener: InputListener) -> None:
        self._extract_data(listener, "ponder")  # optional time budget ignored
        self.input_queue.push(
            Message(MessageType.SET_POSITION, list(self.list_of_moves))
        )
        self.input_queue.push(Message(MessageType.START_SEARCH, "ponder"))

    def _in_stop(self, listener: InputListener) -> None:
        listener.consume_line()
        self.input_queue.push(Message(MessageType.STOP_SEARCH))

    def _in_showforbid(self, listener: InputListener) -> None:
        listener.consume_line()
        self.input_queue.push(
            Message(MessageType.SET_POSITION, list(self.list_of_moves))
        )
        self.input_queue.push(Message(MessageType.START_SEARCH, "showforbid"))

    def _in_balance(self, listener: InputListener) -> None:
        data = self._extract_data(listener, "balance")
        self.input_queue.push(
            Message(MessageType.SET_POSITION, list(self.list_of_moves))
        )
        self.input_queue.push(Message(MessageType.START_SEARCH, f"balance {data}"))

    def _in_clearhash(self, listener: InputListener) -> None:
        listener.consume_line()
        self.input_queue.push(Message(MessageType.SET_OPTION, ("clear_hash", "1")))
        self.output_queue.push(Message(MessageType.PLAIN_STRING, "OK"))

    def _in_protocolversion(self, listener: InputListener) -> None:
        listener.consume_line()
        self.output_queue.push(Message(MessageType.PLAIN_STRING, "1"))

    def _in_proboard(self, listener: InputListener) -> None:
        """Pro/long-pro openings are not supported, acknowledged as unknown
        (reference: ExtendedGomocupProtocol.cpp:281-290)."""
        line = listener.get_line()
        self.output_queue.push(Message(MessageType.UNKNOWN_COMMAND, line))

    def _read_ordered_moves(self, listener: InputListener) -> list[Move]:
        moves: list[Move] = []
        sign = CROSS
        while True:
            line = listener.get_line()
            if line.strip().lower() == "done":
                break
            m = self.move_from_string(line, sign)
            self._check_valid(m, moves)
            moves.append(m)
            sign = invert_sign(sign)
        return moves

    def _in_swapboard(self, listener: InputListener) -> None:
        """Swap opening: after 1 stone, decide swap-or-play
        (reference: ExtendedGomocupProtocol.cpp:291-299)."""
        listener.consume_line()
        self.list_of_moves = self._read_ordered_moves(listener)
        self.input_queue.push(Message(MessageType.STOP_SEARCH))
        self.input_queue.push(
            Message(MessageType.SET_POSITION, list(self.list_of_moves))
        )
        self.input_queue.push(Message(MessageType.START_SEARCH, "swap"))

    def _make_swapx(self, mode: str):
        """swap5/swap1st opening negotiations over the wire (the reference
        ships Swap5Controller/Swap1stController but never dispatches them,
        dispatcher.cpp:22-31; here they are reachable via SWAP5BOARD /
        SWAP1STBOARD in the style of SWAPBOARD)."""

        def fn(listener: InputListener) -> None:
            listener.consume_line()
            self.list_of_moves = self._read_ordered_moves(listener)
            self.input_queue.push(Message(MessageType.STOP_SEARCH))
            self.input_queue.push(
                Message(MessageType.SET_POSITION, list(self.list_of_moves))
            )
            self.input_queue.push(Message(MessageType.START_SEARCH, mode))

        return fn

    def _in_swap2board(self, listener: InputListener) -> None:
        """Swap2 opening negotiation (reference:
        ExtendedGomocupProtocol.cpp SWAP2BOARD + Swap2Controller)."""
        listener.consume_line()
        self.list_of_moves = self._read_ordered_moves(listener)
        self.input_queue.push(Message(MessageType.STOP_SEARCH))
        self.input_queue.push(
            Message(MessageType.SET_POSITION, list(self.list_of_moves))
        )
        self.input_queue.push(Message(MessageType.START_SEARCH, "swap2"))
