"""Billions of dofs a second of one full momentum residual evaluation
(operator and right-hand side) at the state after the window: the
stepper's bench_residual, repeated between device syncs for at least a
quarter of a second of host clock. None for a stepper without one."""
import time


def read(ctx):
    st = ctx["stepper"]
    if not hasattr(st, "bench_residual"):
        return None
    U, P, dt = ctx["state"]
    sync = ctx["sync"]
    st.bench_residual(U, U, P, dt)
    sync()
    reps, t0 = 0, time.perf_counter()
    while True:
        st.bench_residual(U, U, P, dt)
        reps += 1
        if reps % 10 == 0:
            sync()
            if time.perf_counter() - t0 >= 0.25:
                break
    seconds = (time.perf_counter() - t0) / reps
    return ctx["sut"]["n_dofs"] / seconds / 1e9
