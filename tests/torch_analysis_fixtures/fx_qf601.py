"""QF601 fixture: bare print() in library code vs sanctioned output."""

print("loading")                                 # QF601 module positive


def noisy_helper(x):
    print(f"x = {x}")                            # QF601 positive
    return x + 1


def quiet_helper(x, console):
    console.info(f"x = {x}")                     # negative: Console
    return x + 1


class Reporter:
    def render(self, stream):
        stream.write("done\n")                   # negative: stream API

    def dump(self):
        print("report")                          # QF601 method positive
