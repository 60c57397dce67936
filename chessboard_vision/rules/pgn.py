"""PGN export: digitized games as Standard Algebraic Notation movetext.

Beyond reference scope — the reference emits only console prints and the
live Lichess game (game_session.py:209,225); its users leave a session
with no portable record. Here any UCI move sequence (a finished
GameSession, a tools/process_video timeline, a MultiStreamSession stream)
serializes to a PGN file importable by every chess tool.

SAN generation follows the PGN standard (export format): piece letter,
minimal disambiguation (file first, then rank, then both), 'x' for
captures (pawn captures keep the origin file), '=Q' promotions, castling
as O-O / O-O-O, '+'/'#' suffixes. Built on the in-framework rules engine
(rules/chesslib.py) — python-chess is not a dependency.
"""

from __future__ import annotations

from typing import Iterable, Optional

from chessboard_vision.rules import chesslib as chess
from chessboard_vision.rules.chesslib import (
    Board, Move, PAWN, KING, PIECE_SYMBOLS,
    square_file, square_rank, square_name,
)

_FILES = "abcdefgh"
_RANKS = "12345678"


def san(board: Board, move: Move) -> str:
    """SAN for a legal ``move`` in ``board``'s position (board unchanged)."""
    piece = board.piece_at(move.from_square)
    if piece is None:
        raise ValueError(f"no piece on {square_name(move.from_square)}")

    if board.is_castling(move):
        body = "O-O" if square_file(move.to_square) > square_file(move.from_square) else "O-O-O"
    else:
        capture = board.is_capture(move)
        if piece.piece_type == PAWN:
            body = _FILES[square_file(move.from_square)] + "x" if capture else ""
            body += square_name(move.to_square)
            if move.promotion:
                body += "=" + PIECE_SYMBOLS[move.promotion].upper()
        else:
            body = PIECE_SYMBOLS[piece.piece_type].upper()
            body += _disambiguation(board, move, piece.piece_type)
            if capture:
                body += "x"
            body += square_name(move.to_square)

    board.push(move)
    try:
        if not list(board.legal_moves):
            if board.is_check():
                body += "#"
            # stalemate: no suffix (PGN standard)
        elif board.is_check():
            body += "+"
    finally:
        board.pop()
    return body


def _disambiguation(board: Board, move: Move, piece_type: int) -> str:
    """Minimal SAN disambiguator among same-type pieces that can also
    legally reach the target square (kings never need one)."""
    if piece_type == KING:
        return ""
    others = [
        m.from_square
        for m in board.legal_moves
        if m.to_square == move.to_square
        and m.from_square != move.from_square
        and (p := board.piece_at(m.from_square)) is not None
        and p.piece_type == piece_type
    ]
    if not others:
        return ""
    f, r = square_file(move.from_square), square_rank(move.from_square)
    if all(square_file(sq) != f for sq in others):
        return _FILES[f]
    if all(square_rank(sq) != r for sq in others):
        return _RANKS[r]
    return _FILES[f] + _RANKS[r]


def _result(board: Board, claim_draws: bool = False) -> str:
    if not list(board.legal_moves):
        if not board.is_check():
            return "1/2-1/2"  # stalemate
        return "0-1" if board.turn == chess.WHITE else "1-0"
    # Draw adjudication: AUTOMATIC terminations —
    # dead position, seventy-five moves, fivefold repetition (FIDE 9.6)
    # — always export 1/2-1/2. Merely CLAIMABLE draws (50-move /
    # threefold) are a claim RIGHT, not an outcome: a game can be lost
    # on time or resigned at a claimable position, so they adjudicate
    # only when the caller asserts the game genuinely ended here
    # (python-chess result(claim_draw=...) semantics).
    if (
        board.is_insufficient_material()
        or board.is_seventyfive_moves()
        or board.is_fivefold_repetition()
    ):
        return "1/2-1/2"
    if claim_draws and board.can_claim_draw():
        return "1/2-1/2"
    return "*"


def game_to_pgn(
    uci_moves: Iterable[str],
    headers: Optional[dict] = None,
    start_fen: Optional[str] = None,
    result: Optional[str] = None,
    comments: Optional[dict] = None,
    claim_draws: bool = False,
) -> str:
    """Serialize a UCI move sequence to a PGN string.

    headers: extra/overriding Seven-Tag-Roster values; start_fen sets the
    SetUp/FEN tags for games digitized mid-position (checkpoint resumes);
    result overrides the auto-derived termination (e.g. '1-0' on a
    resignation the move list can't show); comments maps 0-based move
    indices to brace-comment text (e.g. '[%clk 0:04:32]' — emitted as
    {...} after the move, the standard clock-annotation form);
    claim_draws adjudicates a final position that is a CLAIMABLE draw
    (50-move / threefold) as 1/2-1/2 — set it when the move list is the
    whole game (e.g. a fully digitized recording), leave it off when the
    game may have ended another way (time, resignation, still running).
    """
    board = Board(start_fen) if start_fen else Board()
    sans = []
    for u in uci_moves:
        move = Move.from_uci(u) if isinstance(u, str) else u
        if move not in board.legal_moves:
            raise ValueError(f"illegal move in sequence: {u}")
        sans.append(san(board, move))
        board.push(move)

    res = result or _result(board, claim_draws)
    tags = {
        "Event": "chessboard_vision digitized game",
        "Site": "?",
        "Date": "????.??.??",
        "Round": "?",
        "White": "?",
        "Black": "?",
        "Result": res,
    }
    if start_fen:
        tags["SetUp"] = "1"
        tags["FEN"] = start_fen
    if headers:
        tags.update(headers)
        res = tags["Result"]

    def esc(v):  # PGN spec: quote and backslash are backslash-escaped
        return str(v).replace("\\", "\\\\").replace('"', '\\"')

    lines = [f'[{k} "{esc(v)}"]' for k, v in tags.items()]
    lines.append("")

    # Movetext with move numbers; black-to-move starts get 'N... '.
    tokens = []
    start_board = Board(start_fen) if start_fen else Board()
    num = start_board.fullmove_number
    white_to_move = start_board.turn == chess.WHITE
    if sans and not white_to_move:
        tokens.append(f"{num}...")
    for i, s in enumerate(sans):
        if white_to_move:
            tokens.append(f"{num}.")
        tokens.append(s)
        if comments and i in comments:
            tokens.append("{" + str(comments[i]) + "}")
        if not white_to_move:
            num += 1
        white_to_move = not white_to_move
    tokens.append(res)

    line = ""
    for tok in tokens:
        if len(line) + len(tok) + 1 > 80:
            lines.append(line)
            line = tok
        else:
            line = tok if not line else line + " " + tok
    lines.append(line)
    return "\n".join(lines) + "\n"


def parse_san(board: Board, token: str) -> Move:
    """Inverse of san(): resolve a SAN token to the unique legal move.

    Accepts export-format SAN (suffixes '+', '#', '!?' annotations are
    ignored). Raises ValueError when no legal move (or more than one —
    an under-disambiguated token) matches. Exists chiefly so the writer
    can be round-trip verified without an external chess library.
    """
    body = token.rstrip("+#!?")
    if body in ("O-O", "0-0", "O-O-O", "0-0-0"):
        short = body in ("O-O", "0-0")
        for m in board.legal_moves:
            if board.is_castling(m) and (
                (square_file(m.to_square) > square_file(m.from_square)) == short
            ):
                return m
        raise ValueError(f"no legal castling move for {token!r}")

    promotion = None
    if "=" in body:
        body, promo = body.split("=", 1)
        promotion = PIECE_SYMBOLS.index(promo[0].lower())

    if body[0] in "NBRQK":
        piece_type = PIECE_SYMBOLS.index(body[0].lower())
        body = body[1:]
    else:
        piece_type = PAWN

    body = body.replace("x", "")
    dest = body[-2:]
    hint = body[:-2]  # '', file, rank, or file+rank
    if dest[0] not in _FILES or dest[1] not in _RANKS:
        raise ValueError(f"bad SAN destination in {token!r}")
    to_sq = _FILES.index(dest[0]) + 8 * _RANKS.index(dest[1])

    matches = []
    for m in board.legal_moves:
        if m.to_square != to_sq or (m.promotion or None) != promotion:
            continue
        p = board.piece_at(m.from_square)
        if p is None or p.piece_type != piece_type:
            continue
        f, r = square_file(m.from_square), square_rank(m.from_square)
        if any(c in _FILES and _FILES.index(c) != f for c in hint):
            continue
        if any(c in _RANKS and _RANKS.index(c) != r for c in hint):
            continue
        matches.append(m)
    if len(matches) != 1:
        raise ValueError(
            f"SAN {token!r} matches {len(matches)} legal moves"
        )
    return matches[0]
