"""Rainbow output filter for `--epic` mode (the reference ships a lolcat
vendored as interfaces/epic.py:1; this is a from-scratch minimal take:
read stdin, write each line with a phase-shifted 256-color sine gradient).

Don't ask."""

import math
import sys


def _rainbow_color(position: float) -> int:
    """256-color-cube index on a sine rainbow."""
    red = math.sin(position) * 127 + 128
    green = math.sin(position + 2 * math.pi / 3) * 127 + 128
    blue = math.sin(position + 4 * math.pi / 3) * 127 + 128
    return (
        16
        + int(red * 5 / 256) * 36
        + int(green * 5 / 256) * 6
        + int(blue * 5 / 256)
    )


def colorize(stream_in, stream_out, freq: float = 0.1) -> None:
    offset = 0
    for line in stream_in:
        offset += 1
        out = []
        for column, char in enumerate(line.rstrip("\n")):
            color = _rainbow_color(freq * (offset + column))
            out.append(f"\x1b[38;5;{color}m{char}")
        stream_out.write("".join(out) + "\x1b[0m\n")
    stream_out.flush()


def main() -> None:
    try:
        colorize(sys.stdin, sys.stdout)
        sys.stdout.write("\x1b[0m")
    except KeyboardInterrupt:
        try:
            sys.stdout.write("\x1b[0m")
        except Exception:
            pass
    except BrokenPipeError:
        # downstream closed (e.g. `| head`): silence the interpreter-exit
        # flush by pointing stdout at devnull — writing a reset here would
        # just raise again
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())


if __name__ == "__main__":
    main()
