"""ITA2 Baudot code tables (a copy of pebblesdr_tpu/modem/baudot.py: the
BaudotCode capability, plugins/RttyDigitalModem/baudotcode.{h,cpp})."""

LTRS = [
    "\0", "E", "\n", "A", " ", "S", "I", "U", "\r", "D", "R", "J", "N", "F",
    "C", "K", "T", "Z", "L", "W", "H", "Y", "P", "Q", "O", "B", "G", "<FIGS>",
    "M", "X", "V", "<LTRS>",
]
FIGS = [
    "\0", "3", "\n", "-", " ", "'", "8", "7", "\r", "$", "4", "\a", ",", "!",
    ":", "(", "5", '"', ")", "2", "#", "6", "0", "1", "9", "?", "&", "<FIGS>",
    ".", "/", ";", "<LTRS>",
]

LTRS_SHIFT = 0x1F
FIGS_SHIFT = 0x1B


def decode_symbol(code: int, figs: bool) -> tuple[str, bool]:
    """(char, new_figs_state); shift codes return ''. code is 5 bits."""
    if code == LTRS_SHIFT:
        return "", False
    if code == FIGS_SHIFT:
        return "", True
    table = FIGS if figs else LTRS
    ch = table[code & 0x1F]
    return ("" if ch in ("\0",) else ch), figs


CHAR_TO_CODE = {}
for _i, _c in enumerate(LTRS):
    if _c not in ("<FIGS>", "<LTRS>", "\0"):
        CHAR_TO_CODE[_c] = (_i, False)
for _i, _c in enumerate(FIGS):
    if _c not in ("<FIGS>", "<LTRS>", "\0") and _c not in CHAR_TO_CODE:
        CHAR_TO_CODE[_c] = (_i, True)
