"""QF501 fixture: env wrappers bypassing the _wrap tagging protocol."""


def _wrap(env, name, *, reset, step):
    step._wrapper_stack = (name,)
    return env.replace(reset=reset, step=step)   # negative: inside _wrap


def bad_wrapper(env):
    def step(state, action):
        return env.step(state, action)

    return env.replace(step=step)                # QF501 positive


def good_wrapper(env):
    def step(state, action):
        return env.step(state, action)

    return _wrap(env, "good", reset=env.reset, step=step)   # negative
