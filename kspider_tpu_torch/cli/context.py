"""Click group of ``python -m kspider_tpu_torch``.

Reuses the help-priority group class of ``kspider_tpu.cli.context``, which
is jax-free at import; the group itself sets up no JAX compile cache."""

import click

from kspider_tpu.cli.context import HelpPriorityGroup
from kspider_tpu.utils.logger import Logger
from kspider_tpu_torch import __version__


@click.group(cls=HelpPriorityGroup)
@click.version_option(version=__version__, prog_name="kSpider-TPU-torch")
@click.option("-q", "--quiet", default=False, is_flag=True)
@click.pass_context
def cli(ctx, quiet):
    ctx.obj = Logger(quiet)
