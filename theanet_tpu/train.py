"""Training CLI: ``python -m theanet_tpu.train <dataset> <prms-or-pkl> [redirect]``

Protocol parity with the reference driver (reference train.py:59-245):

  * args: dataset module name, .prms config or .pkl resume checkpoint,
    optional trailing '1' to tee stdout to <head>_<SEED>.txt;
  * prints the env banner, layer/param/weight info, then the epoch table
    ``Epoch Cost Tr_Error Tr_X Te_Error Te_X`` with the second statistic
    named BitErr for LOGIT heads and P(MLE) otherwise;
  * rotating-window eval every EPOCHS_TO_TEST epochs, checkpoint written as
    <head>_<SEED>_<testerr>.pkl with the previous checkpoint deleted;
  * NaN-cost abort with weight dump, Exp-head divergence diagnostics, and the
    high-cost weight dump;
  * final full-dataset evaluation row.

Difference from the reference: an epoch is one device program (lax.scan), so
the watchdogs consume the scanned per-batch outputs after the epoch returns
instead of intercepting each host-side batch call.
"""

from __future__ import annotations

import os
import socket
import sys
from datetime import datetime

import numpy as np

import jax


class OutputLog:
    """stdout replacement that optionally redirects the epoch protocol into a
    line-buffered log file (the reference's redirect-to-``<head>_<SEED>.txt``
    behavior, train.py:100-104).

    ``checkpoint_flush`` is called at every test interval so the log is
    durable on disk even if the run dies mid-epoch — line buffering plus an
    fsync, rather than the reference's close-and-reopen trick.
    """

    def __init__(self, path: str | None = None):
        self._file = open(path, "w", buffering=1) if path else None
        # honor whatever stdout was active when the redirect was installed
        # (a caller's contextlib.redirect_stdout, a test harness, ...)
        self._console = sys.stdout

    @property
    def _target(self):
        return self._file if self._file is not None else self._console

    def write(self, text):
        return self._target.write(text)

    def checkpoint_flush(self):
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())

    def __getattr__(self, attr):
        return getattr(self._target, attr)


def main(argv=None):
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 3:
        print(
            f"Usage: {argv[0]} <dataset> <config.prms | checkpoint.pkl> "
            "[redirect]\n\n"
            "  dataset    data module name; resolved as data.<name> first,\n"
            "             then theanet_tpu.data.<name> (mnist, synth, ...)\n"
            "  .prms      fresh run from a Python-literal config dict\n"
            "  .pkl       resume training from a saved checkpoint\n"
            "  redirect   pass 1 to write the epoch log to "
            "<config>_<SEED>.txt\n"
        )
        sys.exit(1)

    dataset_name = argv[1]
    prms_file_name = argv[2]

    from .compile_cache import enable as _enable_compile_cache

    _enable_compile_cache()  # warm-start repeat configs

    from .model import NeuralNet, get_layers_info, get_training_params_info
    from .prms import fixdim, load_params, save_checkpoint
    from .trainer import Trainer, get_test_indices
    from .data import load_dataset

    layers, tr_prms, allwts = load_params(prms_file_name)

    out_file_head = os.path.basename(prms_file_name).replace(
        os.path.splitext(prms_file_name)[1], "_{:06d}".format(tr_prms["SEED"])
    )

    if argv[-1] == "1":
        print("Printing output to {}.txt".format(out_file_head), file=sys.stderr)
        sys.stdout = OutputLog(out_file_head + ".txt")
    else:
        sys.stdout = OutputLog()

    print(" ".join(argv), file=sys.stderr)
    print(" ".join(argv))
    print("Time   :" + datetime.now().strftime("%Y-%m-%d %H:%M:%S"))
    print(
        "Device : {} ({})".format(
            jax.devices()[0].platform, jax.devices()[0].device_kind
        )
    )
    print("Host   :", socket.gethostname())
    print(get_layers_info(layers))
    print(get_training_params_info(tr_prms))

    # ------------------------------------------------------ data
    data = load_dataset(dataset_name)
    training_x = fixdim(data.training_x)
    testing_x = fixdim(data.testing_x)
    tr_corpus_sz, n_maps, _, img_sz = training_x.shape
    te_corpus_sz = testing_x.shape[0]
    layers[0][1]["img_sz"] = img_sz
    if "num_maps" not in layers[0][1] and n_maps != 1:
        layers[0][1]["num_maps"] = n_maps

    training_aux = getattr(data, "training_aux", None)
    testing_aux = getattr(data, "testing_aux", None)

    print("\nInitializing the net ... ")
    net = NeuralNet(layers, tr_prms, allwts)
    print(net)
    print(net.get_wts_info(detailed=True).replace("\n\t", ""))

    print("\nCompiling ... ")
    trainer = Trainer(
        net,
        training_x,
        data.training_y,
        testing_x,
        data.testing_y,
        train_aux=training_aux,
        test_aux=testing_aux,
    )

    batch_sz = tr_prms["BATCH_SZ"]
    n_epochs = tr_prms["NUM_EPOCHS"]

    if net.head.kind == "LOGIT":
        aux_err_name = "BitErr"
    else:
        aux_err_name = "P(MLE)"

    test_indices = get_test_indices(te_corpus_sz, batch_sz, tr_prms["TEST_SAMP_SZ"])
    trin_indices = get_test_indices(tr_corpus_sz, batch_sz, tr_prms["TEST_SAMP_SZ"])
    pickle_file_name = out_file_head + "_{:02.0f}.pkl"
    saved_file_name = None

    def do_test():
        nonlocal saved_file_name
        test_err, aux_test_err = trainer.evaluate("test", next(test_indices))
        trin_err, aux_trin_err = trainer.evaluate("train", next(trin_indices))
        print(
            "{:5.2f}%  ({:5.2f}%)      {:5.2f}%  ({:5.2f}%)".format(
                trin_err, aux_trin_err, test_err, aux_test_err
            )
        )
        sys.stdout.checkpoint_flush()

        if saved_file_name:
            os.remove(saved_file_name)
        saved_file_name = pickle_file_name.format(test_err)
        save_checkpoint(saved_file_name, trainer.checkpoint_dict())

    np.set_printoptions(precision=2)
    print("Training ...")
    print("Epoch   Cost  Tr_Error Tr_{0}    Te_Error Te_{0}".format(aux_err_name))

    # Observability: per-epoch wall-clock/throughput on stderr (stdout keeps
    # the reference's exact table), optional jax.profiler trace of epoch 0
    # into $THEANET_PROFILE_DIR (SURVEY.md §5.1: the reference has no
    # tracing; this is its replacement).
    import time as _time

    profile_dir = os.environ.get("THEANET_PROFILE_DIR")
    n_train_imgs = trainer.n_train_batches * batch_sz

    # THEANET_STEPWISE=1 switches from the fused scanned epoch to per-batch
    # host-dispatched steps — the reference's exact granularity, where the
    # NaN/divergence watchdogs can interrupt mid-epoch (train.py:210-226).
    # ~2-5x slower; use for debugging diverging runs.
    stepwise = os.environ.get("THEANET_STEPWISE") == "1"

    def run_epoch_stepwise(epoch):
        costs, min_true_f = [], []
        nb = trainer.n_train_batches
        for ibatch in range(nb):
            cost, feats, _ = trainer.run_batch(ibatch, epoch * nb + ibatch)
            y = np.asarray(data.training_y[ibatch * batch_sz : (ibatch + 1) * batch_sz])
            costs.append(cost)
            min_true_f.append(feats[np.arange(len(y)), y].min())
            if np.isnan(cost):
                break
        # plain sum ON PURPOSE: a NaN cost must reach watchdogs() as a NaN
        # total (np.nansum would strip the very signal the break detected)
        return float(np.sum(costs)), np.asarray(costs), np.asarray(min_true_f)

    is_exp_head = layers[-1][0][:3] == "Exp"
    epochs_to_test = tr_prms["EPOCHS_TO_TEST"]

    # Chained-epoch dispatch: when several epochs separate consecutive test
    # intervals, run them as one run_epochs(k) call — k device programs
    # dispatched back-to-back with ONE final sync, so the host never waits
    # for the device between them. Watchdogs then fire at chunk
    # granularity over the stacked per-epoch streams. Per-epoch dispatch is
    # kept for stepwise debugging and for profiler runs (which trace epoch 1
    # in isolation).
    chain = not stepwise and not profile_dir

    def watchdogs(epoch, total_cost, costs, min_true_f):
        # Reference train.py:214-226, applied to scanned outputs. sync_net
        # pulls the CURRENT device weights into the net before printing
        # (layer weights otherwise hold init/last-checkpoint values).
        if is_exp_head and float(min_true_f.min()) < -6:
            ibatch = int(min_true_f.argmin())
            print("Epoch:{} Iteration:{}".format(epoch, ibatch))
            print("min true-class feature:", float(min_true_f.min()))
            trainer.sync_net()
            print(net.get_wts_info(detailed=True))

        if np.isnan(total_cost):
            ibatch = int(np.argmax(np.isnan(costs)))
            print("Epoch:{} Iteration:{}".format(epoch, ibatch))
            trainer.sync_net()
            print(net.get_wts_info(detailed=True))
            raise ZeroDivisionError(
                "Nan cost at Epoch:{} Iteration:{}".format(epoch, ibatch)
            )

    epoch = 0
    while epoch < n_epochs:
        if chain:
            # chunk ends at the next test boundary (epoch % EPOCHS_TO_TEST
            # == 0 triggers a test, reference train.py:228), or at the final
            # epoch for a trailing partial interval
            if epoch % epochs_to_test == 0:
                chunk_end = epoch
            else:
                chunk_end = min(
                    (epoch // epochs_to_test + 1) * epochs_to_test,
                    n_epochs - 1,
                )
            chunk_len = chunk_end - epoch + 1
        else:
            chunk_len = 1

        if profile_dir and epoch == 1:  # epoch 0 includes compile; trace epoch 1
            try:
                jax.profiler.start_trace(profile_dir)
            except Exception as e:  # profiling is best-effort on exotic backends
                print("profiler unavailable:", e, file=sys.stderr)
                profile_dir = None
        t_epoch = _time.time()
        if chain:
            # advances the epoch counter / LR schedule internally, per epoch
            test_row_epoch = net.get_epoch() + chunk_len - 1
            # device-side state copy: lets a NaN inside the chunk replay to
            # the failing epoch for at-failure diagnostics (see below)
            snap = trainer.snapshot_state()
            totals, costs2d, minf2d = trainer.run_epochs(chunk_len)
        elif stepwise:
            total_cost, costs, min_true_f = run_epoch_stepwise(epoch)
        else:
            total_cost, costs, min_true_f = trainer.run_epoch()
        dt = _time.time() - t_epoch
        if profile_dir and epoch == 1:
            jax.profiler.stop_trace()
            print("profiler trace written to", profile_dir, file=sys.stderr)
        print(
            "epoch{} {} took {:.2f}s ({:,.0f} images/sec)".format(
                "s" if chunk_len > 1 else "",
                "{}-{}".format(epoch, epoch + chunk_len - 1)
                if chunk_len > 1 else epoch,
                dt, n_train_imgs * chunk_len / dt
            ),
            file=sys.stderr,
        )

        if chain:
            replayed = False
            for j in range(chunk_len):
                nan_j = np.isnan(totals[j])
                div_j = is_exp_head and float(minf2d[j].min()) < -6
                if (nan_j or div_j) and j < chunk_len - 1:
                    # the chunk trained past the failure; rewind to the
                    # chunk start and replay up to the failing epoch so the
                    # watchdog dump (NaN abort OR Exp-head divergence)
                    # prints the at-failure weights the reference's
                    # per-batch loop would have shown (the replay is
                    # deterministic: LR and all per-epoch RNG derive from
                    # the restored epoch counter)
                    trainer.restore_state(snap)
                    trainer.run_epochs(j + 1)
                    replayed = True
                watchdogs(epoch + j, float(totals[j]), costs2d[j], minf2d[j])
            if replayed:
                # only the divergence dump returns here (NaN raises): put
                # the state back where the chained run had already gotten
                trainer.restore_state(snap)
                trainer.run_epochs(chunk_len)
            total_cost = float(totals[-1])
        else:
            watchdogs(epoch, total_cost, costs, min_true_f)
            test_row_epoch = net.get_epoch()

        if (epoch + chunk_len - 1) % epochs_to_test == 0:
            print("{:3d} {:>8.2f}".format(test_row_epoch, total_cost), end="    ")
            do_test()
            if total_cost > 1e6:
                trainer.sync_net()
                print(net.get_wts_info(detailed=True))

        if not chain:
            net.inc_epoch_set_rate()
        epoch += chunk_len

    # ---------------------------------------------- final full-set eval
    test_err, aux_test_err = trainer.evaluate_full("test")
    trin_err, aux_trin_err = trainer.evaluate_full("train")
    print("{:3d} {:>8.2f}".format(net.get_epoch(), 0), end="    ")
    print(
        "{:5.2f}%  ({:5.2f}%)      {:5.2f}%  ({:5.2f}%)".format(
            trin_err, aux_trin_err, test_err, aux_test_err
        )
    )
    return trainer


if __name__ == "__main__":
    main()
