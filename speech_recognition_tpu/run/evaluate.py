"""Evaluation entry point: decode a dataset, report WER/CER.

CLI surface parity with reference speech_recognition/run/evaluate.py.
"""

import argparse
import csv
import sys

from ..utils import get_logger, levenshtein_distance, open_file

# fmt: off
parser = argparse.ArgumentParser("This is script to evaluate (decode and score) a trained model")
parser.add_argument("--data-config", type=str, required=True, help="data processing config file")
parser.add_argument("--model-config", type=str, required=True, help="model config file")
parser.add_argument("--dataset-paths", required=True, help="a tsv/tfrecord dataset file or multiple files ex) *.tsv")
parser.add_argument("--model-path", type=str, required=True, help="pretrained model checkpoint")
parser.add_argument("--sp-model-path", type=str, required=True, help="sentencepiece model path")
parser.add_argument("--output-path", help="output tsv file path to save generated sentences")
parser.add_argument("--batch-size", type=int, default=512)
parser.add_argument("--beam-size", type=int, default=0, help="not given, use greedy search else beam search with this value as beam size")
parser.add_argument("--use-tfrecord", action="store_true", help="use tfrecord dataset")
parser.add_argument("--mixed-precision", action="store_true", help="Use mixed precision")
parser.add_argument("--device", type=str, default="CPU", choices=["CPU", "GPU"], help="device to run on")
parser.add_argument("--on-device-frontend", action=argparse.BooleanOptionalAction, help="compute audio features on device (default: on for GPU tsv runs)")
# fmt: on


def main(args: argparse.Namespace):
    logger = get_logger("evaluate")

    from ..backend import select_device
    from .common import build_variables, compute_dtype, create_model

    select_device(args.device)

    import numpy as np

    from ..configs import DataConfig, get_model_config
    from ..data import SentencePieceTokenizer, get_dataset, get_tfrecord_dataset
    from ..models import LAS, Transducer
    from ..ops.features import delta_accelerate
    from ..search import DeepSpeechSearcher, LASSearcher, TransducerSearcher
    from ..train import restore_weights

    import jax

    if args.mixed_precision:
        logger.info("[+] Use Mixed Precision (bfloat16)")

    logger.info(f"[+] Load Tokenizer from {args.sp_model_path}")
    with open_file(args.sp_model_path, "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    bos_id, eos_id = tokenizer.tokenize("")

    logger.info(f"[+] Load Data Config from {args.data_config}")
    config = DataConfig.from_yaml(args.data_config)

    from .common import frontend_decode_fn, use_raw_frontend

    raw_mode = use_raw_frontend(getattr(args, "on_device_frontend", None), args.device, args.use_tfrecord)

    # ------------------------------------------------------------------ dataset
    if args.use_tfrecord:
        logger.info(f"[+] Load TFRecord dataset from {args.dataset_paths}")
        stream = get_tfrecord_dataset(args.dataset_paths)
    elif raw_mode:
        # fused on-device frontend: the host only decodes + tokenizes (the
        # per-core host feature ceiling would otherwise cap decode
        # throughput); features fold into the device step
        logger.info(f"[+] Load dataset from {args.dataset_paths}")
        logger.info("[+] Fused on-device audio frontend")
        stream = get_dataset(args.dataset_paths, config.file_format, config.sample_rate, tokenizer)
    else:
        logger.info(f"[+] Load dataset from {args.dataset_paths}")
        feature_fn = config.make_audio_feature_fn("numpy")
        # feature extraction runs inside the decode thread pool so host prep
        # overlaps the (much slower) device decode loop
        stream = get_dataset(
            args.dataset_paths, config.file_format, config.sample_rate, tokenizer,
            map_fn=lambda a, t: (feature_fn(a), t),
        )
    if config.use_delta_accelerate and not raw_mode:
        logger.info("[+] Use delta and deltas accelerate")
        stream = ((delta_accelerate(a), t) for a, t in stream)

    # -------------------------------------------------------------------- model
    model_config = get_model_config(args.model_config)
    dtype = compute_dtype(args.mixed_precision, args.device)
    model = create_model(model_config, dtype)
    variables = build_variables(model, model_config, config, jax.random.PRNGKey(0))
    logger.info(f"[+] Load weights of model from {args.model_path}")
    variables = dict(restore_weights(args.model_path, variables))

    if isinstance(model, LAS):
        searcher = LASSearcher(model, variables, config.max_token_length, bos_id, eos_id, model_config.pad_id)
    elif isinstance(model, Transducer):
        searcher = TransducerSearcher(
            model, variables, config.max_token_length, bos_id, eos_id, model_config.pad_index
        )
    else:
        # any CTC-family model (DeepSpeech2, Conformer): the searcher only
        # needs model.apply -> logits plus the blank index
        searcher = DeepSpeechSearcher(model, variables, model_config.blank_index)

    from ..data.dataset import quantized_padded_batch

    # static max shapes on the accelerator; bounded quantized shapes
    # elsewhere (dynamic per-batch pads would recompile the decode loop for
    # every distinct T)
    from .common import decode_pad_lengths

    audio_pad, token_pad = decode_pad_lengths(config, args.device)

    # ---------------------------------------------------------------- inference
    logger.info("[+] Start Inference")
    outputs = []
    from ..data.dataset import prefetch_stream

    # double-buffered batches: host batch prep overlaps the device decode
    # bf16 feature shipping under mixed precision: bit-identical to the
    # model's on-device astype cast, half the host->device bytes
    host_dtype = np.dtype(dtype) if args.mixed_precision else np.float32
    if raw_mode:
        from ..data.dataset import quantized_padded_raw_batch

        batches = prefetch_stream(
            quantized_padded_raw_batch(
                stream, args.batch_size, config.frame_length, config.frame_step,
                max_frames=audio_pad,
            ),
            size=2,
        )
    else:
        batches = prefetch_stream(
            quantized_padded_batch(
                stream, args.batch_size, audio_pad_length=audio_pad, token_pad_length=token_pad,
                audio_dtype=host_dtype,
            ),
            size=2,
        )
    if args.beam_size > 0:
        decode_fn = lambda audio: searcher.beam_search(audio, args.beam_size)[0][:, 0, :]
    else:
        decode_fn = lambda audio: searcher.greedy_search(audio)[0]
    if raw_mode:
        decode_fn = frontend_decode_fn(config, decode_fn)
    # multi-device: shard the batch rows over a data mesh (SPMD decode)
    from .common import sharded_decode_fn

    decode_fn, decode_mesh = sharded_decode_fn(decode_fn, args.batch_size)
    if decode_mesh is not None:
        logger.info(f"[+] SPMD decode over mesh {dict(zip(decode_mesh.axis_names, decode_mesh.devices.shape))}")
    # keep two decode calls in flight: dispatch for batch N+1 overlaps the
    # device execution of batch N (run/common.py pipelined_decode)
    from .common import timed_decode

    for batch_output, batch_tokens, n_valid in timed_decode(batches, decode_fn, config, raw_mode, logger):
        outputs.extend(zip(batch_output[:n_valid], batch_tokens[:n_valid]))
    logger.info("[+] Ended Inference")

    to_str = lambda tokens: tokenizer.detokenize([int(t) for t in tokens])
    outputs = [(to_str(pred), to_str(target)) for pred, target in outputs]

    wers, cers = [], []
    for pred, target in outputs:
        wers.append(levenshtein_distance(target.split(), pred.split(), True))
        cers.append(levenshtein_distance(target, pred, True))

    logger.info(f"[+] Average WER: {sum(wers) / len(wers) * 100:.4f}%")
    logger.info(f"[+] Average CER: {sum(cers) / len(cers) * 100:.4f}%")

    if args.output_path:
        with open_file(args.output_path, "w") as fout:
            wtr = csv.writer(fout, delimiter="\t")
            wtr.writerow(["Prediction", "Target", "WER", "CER"])
            for (pred, target), wer, cer in zip(outputs, wers, cers):
                wtr.writerow((pred, target, wer, cer))
        logger.info(f"[+] Saved (Prediction, Target) pairs to {args.output_path}")
    return 0 if outputs else 1


if __name__ == "__main__":
    from ..backend import setup_compile_cache

    setup_compile_cache()
    sys.exit(main(parser.parse_args()))
