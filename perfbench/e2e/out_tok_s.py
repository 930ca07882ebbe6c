"""Output tokens generated in the window over the window's seconds: every
request counts, finished or not."""


def read(run):
    tokens = sum(n1 - run.snap0.get(i, (0,))[0]
                 for i, (n1, *_) in run.snap1.items())
    return tokens / run.seconds
