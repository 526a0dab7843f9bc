"""Click group of ``python -m kspider_tpu_torch``, with help-priority
ordering like the reference's ``SpecialHelpOrder``
(kSpider/pykSpider/kSpider2/click_context.py:6-44).

Attribution: the help-priority Group pattern below is the public click
recipe from Stack Overflow (https://stackoverflow.com/a/47984810,
CC BY-SA) that the reference's ``SpecialHelpOrder`` is also built on —
kept structurally intact for CLI help-output parity."""

import click

from kspider_tpu_torch import __version__
from kspider_tpu_torch.utils.logger import Logger


class HelpPriorityGroup(click.Group):
    def __init__(self, *args, **kwargs):
        self.help_priorities = {}
        super().__init__(*args, **kwargs)

    def get_help(self, ctx):
        self.list_commands = self.list_commands_for_help
        return super().get_help(ctx)

    def list_commands_for_help(self, ctx):
        commands = super().list_commands(ctx)
        return (
            c[1]
            for c in sorted(
                (self.help_priorities.get(command, 1), command)
                for command in commands
            )
        )

    def command(self, *args, **kwargs):
        help_priority = kwargs.pop("help_priority", 1)
        help_priorities = self.help_priorities

        def decorator(f):
            cmd = super(HelpPriorityGroup, self).command(*args, **kwargs)(f)
            help_priorities[cmd.name] = help_priority
            return cmd

        return decorator

    def group(self, *args, **kwargs):
        help_priority = kwargs.pop("help_priority", 1)
        help_priorities = self.help_priorities

        def decorator(f):
            cmd = super(HelpPriorityGroup, self).group(*args, **kwargs)(f)
            help_priorities[cmd.name] = help_priority
            return cmd

        return decorator


@click.group(cls=HelpPriorityGroup)
@click.version_option(version=__version__, prog_name="kSpider-TPU-torch")
@click.option("-q", "--quiet", default=False, is_flag=True)
@click.pass_context
def cli(ctx, quiet):
    ctx.obj = Logger(quiet)
