"""Seconds to build the stepper (layouts, operators, the pressure
hierarchy with its lambda_max), host clock between device syncs."""


def read(ctx):
    return ctx["sut"]["setup"]["stepper"]
