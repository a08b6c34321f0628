"""Letter and number code points that Python's ``unicodedata`` does not class as
such but the ``regex`` package does, for CLIP's split pattern in
``utils/tokenizer.py``.

Python 3.12 ships Unicode 15.0 tables; ``regex`` 2026.7.19 ships newer ones, so
9,661 code points unassigned in 15.0 are letters (``\\p{L}``, 9,568 of them) or
numbers (``\\p{N}``, 93) there. ``NO_CLASS`` holds U+0345 (COMBINING GREEK
YPOGEGRAMMENI): under ``regex.IGNORECASE`` it case-folds to a letter, so the
pattern's other-symbols class ``[^\\s\\p{L}\\p{N}]`` excludes it, while ``\\p{L}``
does not match it either; CLIP's split drops it.

The table was made by testing every code point below 0x110000 with ``regex``
2026.7.19 against ``unicodedata`` (Unicode 15.0)::

    L = regex.compile(r"\\p{L}", regex.IGNORECASE)
    N = regex.compile(r"\\p{N}", regex.IGNORECASE)
    for cp in range(0x110000):
        major = unicodedata.category(chr(cp))[0]
        if L.match(chr(cp)) and major != "L": ...  # -> LETTERS
        if N.match(chr(cp)) and major != "N": ...  # -> NUMBERS

and merging consecutive code points into inclusive ``(first, last)`` ranges. The
scan found no code point that ``unicodedata`` classes as a letter or number and
``regex`` does not. ``NO_CLASS`` comes from the same scan: the code points that
neither ``\\p{L}``, ``\\p{N}``, ``[^\\s\\p{L}\\p{N}]`` nor ``\\s`` match under
``regex.IGNORECASE``.
"""

LETTERS = (
    (0x0088F, 0x0088F), (0x00C5C, 0x00C5C), (0x00CDC, 0x00CDC), (0x01C89, 0x01C8A),
    (0x0A7CB, 0x0A7CF), (0x0A7D2, 0x0A7D2), (0x0A7D4, 0x0A7D4), (0x0A7DA, 0x0A7DC),
    (0x0A7F1, 0x0A7F1), (0x105C0, 0x105F3), (0x10940, 0x10959), (0x10D4A, 0x10D65),
    (0x10D6F, 0x10D85), (0x10EC2, 0x10EC7), (0x11380, 0x11389), (0x1138B, 0x1138B),
    (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1),
    (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x11DB0, 0x11DDB), (0x13460, 0x143FA),
    (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x16EA0, 0x16EB8), (0x16EBB, 0x16ED3),
    (0x16FF2, 0x16FF3), (0x187F8, 0x187FF), (0x18CFF, 0x18CFF), (0x18D09, 0x18D1E),
    (0x18D80, 0x18DF2), (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0), (0x1E6C0, 0x1E6DE),
    (0x1E6E0, 0x1E6E2), (0x1E6E4, 0x1E6E5), (0x1E6E7, 0x1E6ED), (0x1E6F0, 0x1E6F4),
    (0x1E6FE, 0x1E6FF), (0x2B73A, 0x2B73F), (0x2CEA2, 0x2CEAD), (0x2EBF0, 0x2EE5D),
    (0x323B0, 0x33479),
)
NUMBERS = (
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x11DE0, 0x11DE9),
    (0x16130, 0x16139), (0x16D70, 0x16D79), (0x16FF4, 0x16FF6), (0x1CCF0, 0x1CCF9),
    (0x1E5F1, 0x1E5FA),
)
NO_CLASS = ((0x00345, 0x00345),)
