"""Generate unicode_tables.h: codepoint ranges for \\p{L}, \\p{N}, \\s
exactly as Python's `regex` module (the pre-tokenizer's engine) matches
them, so the C++ pre-tokenizer is parity-by-construction.

Run: python gen_unicode_tables.py > unicode_tables.h
"""

import sys

import regex


def ranges_for(pattern):
    pat = regex.compile(pattern)
    ranges = []
    start = None
    for cp in range(0x110000):
        ch = chr(cp)
        m = pat.match(ch) is not None
        if m and start is None:
            start = cp
        elif not m and start is not None:
            ranges.append((start, cp - 1))
            start = None
    if start is not None:
        ranges.append((start, 0x10FFFF))
    return ranges


def emit(name, ranges, out):
    out.write(f"static const uint32_t {name}[][2] = {{\n")
    for a, b in ranges:
        out.write(f"    {{0x{a:X}, 0x{b:X}}},\n")
    out.write("};\n")
    out.write(
        f"static const size_t {name}_len = "
        f"sizeof({name}) / sizeof({name}[0]);\n\n"
    )


def main(out=sys.stdout):
    out.write("// GENERATED by gen_unicode_tables.py — do not edit.\n")
    out.write("// Ranges match Python regex-module \\p{L}, \\p{N}, \\s.\n")
    out.write("#pragma once\n#include <cstdint>\n#include <cstddef>\n\n")
    emit("kLetterRanges", ranges_for(r"\p{L}"), out)
    emit("kNumberRanges", ranges_for(r"\p{N}"), out)
    emit("kSpaceRanges", ranges_for(r"\s"), out)


if __name__ == "__main__":
    main()
