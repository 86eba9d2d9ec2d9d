"""DP cells a second: every all-pairs cell the window's requests need
(``lx * ly`` at true lengths, counted from the inputs alone), over the
window's wall seconds.  The merge's joins are not counted: their widths
depend on the program's own tree and paths."""


def read(run):
    return run.work().cells / run.window_s
